"""Random-walk pair programs on tensors.

The counterpart of the pair numerics of
``grakel_tpu/kernels/random_walk.py`` (:48-233, XLA programs there,
vmapped over chunks of graph pairs).  Every function takes a batch of
pairs of padded graphs: ``Ax`` [B, V1, V1] and ``Ay`` [B, V2, V2] f32
adjacencies with their valid sizes ``nx``, ``ny`` (int [B]; a graph's
vertices are its first n rows), or per-graph spectra.

Two of them are hand-written kernels on a card:

* K8 (``csrc/rw_cg.cu``), :func:`pair_cg`: the fast geometric kernel of
  a pair, 20 conjugate-gradient steps on ``(I - lamda Ax (x) Ay) x = 1``
  in matrix form, the sum of x; with labels, the matvec of
  ``RandomWalkLabeled``.  One block a pair runs every step.  Its
  plain version :func:`pair_cg_plain` is the JAX package's ``_cg_sum``
  batched in torch: the fixed loop, the per-pair freeze
  ``sqrt(rs) <= rtol ||b||`` and the zero-denominator guards.
* K9 (``csrc/rw_spectral.cu``), :func:`spectral_tile`: the closed-form
  geometric kernel of a tile of graph pairs from each graph's
  eigenvalues and squared eigenvector sums (``_rw_spectral_tile``),
  evaluated in f64 from the f32 spectra; :func:`spectral_tile_plain` is
  the same arithmetic in torch.

The p-step and exponential spectral forms and the dense baselines
(Kronecker product, then a solve or a matrix exponential) are library
work, as in the JAX package: torch calls on the tensors' device, in f32.
"""

from __future__ import annotations

import torch

from .gram import full_fp32

__all__ = ["bucket", "pair_cg", "pair_cg_plain", "pair_cg_cuda",
           "cg_route", "k8_smem_bytes", "k8_global_grid", "spectral_tile",
           "spectral_tile_plain", "spectral_tile_cuda", "pair_spectral",
           "pair_pstep", "pair_pstep_labeled", "pair_baseline_geometric",
           "pair_baseline_exponential", "pair_baseline_labeled",
           "CG_ITERS", "CG_RTOL"]

CG_ITERS = 20      # the reference's maxiter
CG_RTOL = 1e-6     # the reference's rtol

# K8: a block's shared memory at most for the "shared" route (every
# matrix of the pair in shared memory); a pair over it takes the
# "global" route (its matrices in a global scratch of one slot a
# block).  The largest a block may ask for on an H100.
K8_SMEM_MAX = 232448
_K8_TILE = 32
_K8_FIXED = 2 * _K8_TILE * (_K8_TILE + 1) * 4 + 2 * 32 * 4
# blocks of the global route at most (two resident a streaming
# multiprocessor), and the share of the card's free memory its scratch
# may take; fewer blocks each loop over more pairs
K8_GLOBAL_BLOCKS = 264
K8_SCRATCH_SHARE = 0.25


def bucket(n):
    """The padded size of a graph of ``n`` vertices: the next power of
    two, at least 8."""
    return max(8, 1 << (max(int(n) - 1, 1)).bit_length())


def _masks(n, V, device):
    return (torch.arange(V, device=device)[None, :]
            < n.to(device)[:, None]).to(torch.float32)


def _sum2(a):
    return a.sum((1, 2))


# --------------------------------------------------------------------- #
# K8: the pair CG solve
# --------------------------------------------------------------------- #

def pair_cg_plain(Ax, Ay, nx, ny, lamda, Lx=None, Ly=None, n_labels=0,
                  iters=CG_ITERS, rtol=CG_RTOL, return_steps=False):
    """[B] in ``Ax``'s float type (f32 on the paths): for each pair,
    ``sum(x)`` after ``iters`` CG steps on
    ``x - lamda Ax x Ay = b`` (b the valid block's indicator, x0 = 0),
    each pair frozen once ``sqrt(rs) <= rtol ||b||``.  With labels
    ``Lx`` [B, V1], ``Ly`` [B, V2] (ids in [0, n_labels)), the matvec is
    ``x - lamda sum_c Dx_c Ax (M o (x Dy_c Ay))`` with
    ``M[u, v] = [Lx[u] == Ly[v]]``: the JAX package's ``_cg_sum`` with
    ``_pair_cg_geometric`` / ``_pair_cg_labeled``.  ``return_steps``
    also returns the steps each pair ran before it froze (int64 [B]: the
    matvecs K8 does for it)."""
    bx = _masks(nx, Ax.shape[1], Ax.device)
    by = _masks(ny, Ay.shape[1], Ay.device)
    b = (bx[:, :, None] * by[:, None, :]).to(Ax.dtype)
    if Lx is None:
        def mv(X):
            return X - lamda * ((Ax @ X) @ Ay)
    else:
        Lx = Lx.to(torch.int64)
        Ly = Ly.to(torch.int64)
        M = ((Lx[:, :, None] == Ly[:, None, :]) & (bx[:, :, None] > 0)
             & (by[:, None, :] > 0)).to(Ax.dtype)
        labs = torch.arange(n_labels, device=Ax.device)
        oh_x = ((Lx[:, :, None] == labs) & (bx[:, :, None] > 0)).to(Ax.dtype)
        oh_y = ((Ly[:, :, None] == labs) & (by[:, :, None] > 0)).to(Ax.dtype)
        # a label no graph of the batch holds on one side adds exact zeros
        common = [c for c in range(n_labels)
                  if bool(oh_x[:, :, c].any()) and bool(oh_y[:, :, c].any())]

        def mv(X):
            y = torch.zeros_like(X)
            for c in common:
                W = M * ((X * oh_y[:, None, :, c]) @ Ay)
                y = y + oh_x[:, :, c, None] * (Ax @ W)
            return X - lamda * y
    bnorm = torch.sqrt(_sum2(b * b))
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = _sum2(r * r)
    steps = torch.zeros(rs.shape, dtype=torch.int64, device=rs.device)
    with full_fp32():
        for _ in range(iters):
            done = torch.sqrt(rs) <= rtol * bnorm
            steps += ~done
            Ap = mv(p)
            denom = _sum2(p * Ap)
            alpha = torch.where(done | (denom == 0), torch.zeros_like(rs),
                                rs / torch.where(denom == 0,
                                                 torch.ones_like(denom),
                                                 denom))
            x = x + alpha[:, None, None] * p
            r = r - alpha[:, None, None] * Ap
            rs_new = _sum2(r * r)
            beta = torch.where(done | (rs == 0), torch.zeros_like(rs),
                               rs_new / torch.where(rs == 0,
                                                    torch.ones_like(rs), rs))
            p = torch.where(done[:, None, None], p,
                            r + beta[:, None, None] * p)
            rs = torch.where(done, rs, rs_new)
    return (_sum2(x), steps) if return_steps else _sum2(x)


def k8_smem_bytes(V1, V2, labeled):
    """Dynamic shared memory of a K8 block on the shared route at buckets
    V1, V2: the GEMM staging tiles and reduction slots, both adjacencies,
    the five [V1, V2] CG matrices, and the labels."""
    return (_K8_FIXED + 4 * (V1 * V1 + V2 * V2 + 5 * V1 * V2)
            + (4 * (V1 + V2) if labeled else 0))


def cg_route(V1, V2, labeled):
    """K8's route at buckets V1, V2: "shared" when a pair's matrices fit a
    block's shared memory (V1 = V2 = 64 does), else "global"."""
    return "shared" if k8_smem_bytes(V1, V2, labeled) <= K8_SMEM_MAX \
        else "global"


def k8_global_grid(B, V1, V2, free_bytes):
    """Blocks of K8's global route for ``B`` pairs at buckets V1, V2:
    at most :data:`K8_GLOBAL_BLOCKS`, and no more than the scratch slots
    (5 f32 [V1, V2] matrices each) that fit :data:`K8_SCRATCH_SHARE` of
    ``free_bytes``; at least one."""
    slots = int(K8_SCRATCH_SHARE * free_bytes) // (20 * V1 * V2)
    return max(1, min(B, K8_GLOBAL_BLOCKS, slots))


def _f32(t, dev, shape):
    return (t.device == dev and t.dtype == torch.float32
            and tuple(t.shape) == shape and t.is_contiguous())


def _i32(t, dev, shape):
    return (t.device == dev and t.dtype == torch.int32
            and tuple(t.shape) == shape and t.is_contiguous())


def pair_cg_cuda(Ax, Ay, nx, ny, lamda, Lx=None, Ly=None, iters=CG_ITERS,
                 rtol=CG_RTOL):
    """Launch K8 (``csrc/rw_cg.cu``): :func:`pair_cg_plain` on a card, one
    block a pair, every step in one launch.  ``Ax`` [B, V1, V1], ``Ay``
    [B, V2, V2] contiguous f32, ``nx``, ``ny`` int32 [B] (1 <= n <= V),
    labels (with ``Lx`` [B, V1], ``Ly`` [B, V2] int32 ids >= 0 on the
    valid vertices; no label count is needed) on one CUDA device.  The
    route is :func:`cg_route`'s.  Returns f32 [B]."""
    from .. import _build
    dev = Ax.device
    B = Ax.shape[0] if Ax.dim() == 3 else -1
    V1 = Ax.shape[1] if Ax.dim() == 3 else 0
    V2 = Ay.shape[1] if Ay.dim() == 3 else 0
    labeled = Lx is not None
    if not (dev.type == "cuda" and _f32(Ax, dev, (B, V1, V1))
            and _f32(Ay, dev, (B, V2, V2)) and _i32(nx, dev, (B,))
            and _i32(ny, dev, (B,)) and 0 < V1 <= 4096 and 0 < V2 <= 4096
            and (Ly is not None) == labeled
            and (not labeled or (_i32(Lx, dev, (B, V1))
                                 and _i32(Ly, dev, (B, V2))))):
        raise ValueError("pair_cg_cuda: need contiguous tensors on one CUDA "
                         "device: f32 Ax [B, V1, V1] and Ay [B, V2, V2] "
                         "(V <= 4096), int32 nx, ny [B], and int32 Lx "
                         "[B, V1], Ly [B, V2] together or neither")
    route = cg_route(V1, V2, labeled)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    if route == "shared":
        scratch, grid = None, B
        smem = k8_smem_bytes(V1, V2, labeled)
    else:
        grid = k8_global_grid(B, V1, V2, torch.cuda.mem_get_info(dev)[0])
        scratch = torch.empty(grid * 5 * V1 * V2, dtype=torch.float32,
                              device=dev)
        smem = _K8_FIXED
    _build.launch("grakel_rw_cg", dev, Ax.data_ptr(), Ay.data_ptr(),
                  nx.data_ptr(), ny.data_ptr(),
                  Lx.data_ptr() if labeled else None,
                  Ly.data_ptr() if labeled else None, out.data_ptr(), B,
                  V1, V2, float(lamda), int(iters), float(rtol),
                  None if scratch is None else scratch.data_ptr(), grid,
                  smem)
    pair_cg_cuda.launches += 1
    pair_cg_cuda.route_launches[route] += 1
    return out


pair_cg_cuda.launches = 0
pair_cg_cuda.route_launches = {"shared": 0, "global": 0}


def pair_cg(Ax, Ay, nx, ny, lamda, Lx=None, Ly=None, n_labels=0):
    """:func:`pair_cg_plain` for CPU tensors, K8 for CUDA ones."""
    dev = Ax.device
    if dev.type == "cpu":
        return pair_cg_plain(Ax, Ay, nx, ny, lamda, Lx, Ly, n_labels)
    if dev.type != "cuda":
        raise ValueError("pair_cg: unsupported device %s" % dev)
    i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
    return pair_cg_cuda(Ax.contiguous(), Ay.contiguous(), i32(nx), i32(ny),
                        lamda, i32(Lx), i32(Ly))


# --------------------------------------------------------------------- #
# K9: the spectral tile
# --------------------------------------------------------------------- #

def spectral_tile_plain(sx2, mx, nx, sy2, my, ny, lamda):
    """f64 [Bx, By]: ``K[a, b] = sum_i sum_j sx2[a, i] sy2[b, j] /
    (1 - lamda mx[a, i] my[b, j])`` from f32 spectra [Bx, V1] and [By,
    V2] (zero past each graph's size ``nx`` / ``ny``), in f64: the
    denominator ``1 - (lamda mx) my``, the quotient, the sum over j, and
    the sum over i of ``sx2 * term`` in that order.  Padded eigenpairs
    (s2 = mu = 0) add exact zeros, so the loops stop at the largest
    size."""
    n1 = int(nx.max()) if nx.numel() else 0
    n2 = int(ny.max()) if ny.numel() else 0
    lm = float(lamda) * mx[:, :n1].to(torch.float64)
    s1 = sx2[:, :n1].to(torch.float64)
    m2 = my[:, :n2].to(torch.float64)
    s2 = sy2[:, :n2].to(torch.float64)
    acc = torch.zeros((mx.shape[0], my.shape[0]), dtype=torch.float64,
                      device=mx.device)
    for i in range(n1):
        den = 1.0 - lm[:, i, None, None] * m2[None, :, :]
        acc += s1[:, i, None] * (s2[None, :, :] / den).sum(2)
    return acc


def spectral_tile_cuda(sx2, mx, nx, sy2, my, ny, lamda, out=None):
    """Launch K9 (``csrc/rw_spectral.cu``): :func:`spectral_tile_plain` on
    a card, one block a 16 x 16 tile of graph pairs.  ``sx2``, ``mx``
    [Bx, V1] and ``sy2``, ``my`` [By, V2] contiguous f32, ``nx`` [Bx],
    ``ny`` [By] int32 (zero spectra past them), all on one CUDA device;
    ``out`` an f64 [Bx, By] tensor (a view with unit column stride, such
    as a block of a larger Gram; allocated when None).  Returns ``out``."""
    from .. import _build
    dev = mx.device
    Bx, V1 = mx.shape if mx.dim() == 2 else (-1, 0)
    By, V2 = my.shape if my.dim() == 2 else (-1, 0)
    if not (dev.type == "cuda" and _f32(sx2, dev, (Bx, V1))
            and _f32(mx, dev, (Bx, V1)) and _f32(sy2, dev, (By, V2))
            and _f32(my, dev, (By, V2)) and _i32(nx, dev, (Bx,))
            and _i32(ny, dev, (By,)) and 0 < V1 <= 1024 and 0 < V2 <= 1024
            and Bx < 1 << 20 and By < 1 << 20):
        raise ValueError("spectral_tile_cuda: need contiguous tensors on one "
                         "CUDA device: f32 sx2, mx [Bx, V1], sy2, my [By, V2] "
                         "(V <= 1024), int32 nx [Bx], ny [By]")
    if out is None:
        out = torch.empty((Bx, By), dtype=torch.float64, device=dev)
    elif not (out.device == dev and out.dtype == torch.float64
              and tuple(out.shape) == (Bx, By) and out.stride(1) == 1):
        raise ValueError("spectral_tile_cuda: out must be an f64 [Bx, By] "
                         "tensor with unit column stride on the spectra's "
                         "device")
    if Bx and By:
        _build.launch("grakel_rw_spectral", dev, sx2.data_ptr(),
                      mx.data_ptr(), nx.data_ptr(), sy2.data_ptr(),
                      my.data_ptr(), ny.data_ptr(), out.data_ptr(),
                      out.stride(0), Bx, By, V1, V2, float(lamda))
        spectral_tile_cuda.launches += 1
    return out


spectral_tile_cuda.launches = 0


def spectral_tile(sx2, mx, nx, sy2, my, ny, lamda, out=None):
    """:func:`spectral_tile_plain` for CPU tensors (into ``out`` when
    given), K9 for CUDA ones."""
    dev = mx.device
    if dev.type == "cpu":
        K = spectral_tile_plain(sx2, mx, nx, sy2, my, ny, lamda)
        if out is None:
            return K
        out.copy_(K)
        return out
    if dev.type != "cuda":
        raise ValueError("spectral_tile: unsupported device %s" % dev)
    return spectral_tile_cuda(sx2, mx, nx, sy2, my, ny, lamda, out)


# --------------------------------------------------------------------- #
# library work: p-step, exponential and the dense baselines
# --------------------------------------------------------------------- #

def pair_spectral(ux, wx, uy, wy, lamda, mu, exponential):
    """fast + (exponential | p-step): ``k = (ux^2)^T f(wx wy^T) (uy^2)``,
    f32 [B] from spectra [B, V1], [B, V2] (``_pair_spectral``)."""
    W = wx[:, :, None] * wy[:, None, :]
    if exponential:
        F = torch.exp(lamda * W)
    else:
        F = torch.full_like(W, mu[0])
        P = torch.ones_like(W)
        for k in mu[1:]:
            P = P * W
            F = F + k * P
    with full_fp32():
        left = ((ux ** 2)[:, None, :] @ F)[:, 0, :]
    return (left * uy ** 2).sum(1)


def _kron(Ax, Ay):
    B, V1, V2 = Ax.shape[0], Ax.shape[1], Ay.shape[1]
    return (Ax[:, :, None, :, None] * Ay[:, None, :, None, :]).reshape(
        B, V1 * V2, V1 * V2)


def _valid(nx, ny, V1, V2, device):
    bx = _masks(nx, V1, device)
    by = _masks(ny, V2, device)
    return bx[:, :, None] * by[:, None, :]


def pair_baseline_geometric(Ax, Ay, nx, ny, lamda):
    """``b^T (I - lamda Ax (x) Ay)^-1 b`` per pair, f32 [B]
    (``_pair_baseline_geometric``)."""
    V = _valid(nx, ny, Ax.shape[1], Ay.shape[1], Ax.device)
    W = _kron(Ax, Ay)
    b = V.reshape(V.shape[0], -1)
    A = torch.eye(W.shape[1], dtype=W.dtype, device=W.device) - lamda * W
    with full_fp32():
        x = torch.linalg.solve(A, b)
    return (b * x).sum(1)


def pair_baseline_exponential(Ax, Ay, nx, ny, lamda):
    """``b^T expm(lamda Ax (x) Ay) b`` per pair, f32 [B]
    (``_pair_baseline_exponential``)."""
    V = _valid(nx, ny, Ax.shape[1], Ay.shape[1], Ax.device)
    W = _kron(Ax, Ay)
    b = V.reshape(V.shape[0], -1)
    with full_fp32():
        S = torch.linalg.matrix_exp(lamda * W)
        return (b * (S @ b[:, :, None])[:, :, 0]).sum(1)


def pair_pstep(Ax, Ay, nx, ny, mu):
    """The p-step series ``sum_k mu_k b^T W^k b`` by iterated matvecs,
    f32 [B] (``_pair_pstep``)."""
    V = _valid(nx, ny, Ax.shape[1], Ay.shape[1], Ax.device)
    total = mu[0] * _sum2(V * V)
    P = V
    with full_fp32():
        for k in mu[1:]:
            P = Ax @ P @ Ay.transpose(1, 2)
            total = total + k * _sum2(V * P)
    return total


def _label_mask(Lx, Ly, V):
    return (Lx.to(torch.int64)[:, :, None]
            == Ly.to(torch.int64)[:, None, :]).to(V.dtype) * V


def pair_pstep_labeled(Ax, Ay, Lx, Ly, nx, ny, mu):
    """The labeled p-step series: each matvec ``s o (Ax (P o s) Ay^T)``
    with ``s[u, v] = [Lx[u] == Ly[v]]`` on the valid block, f32 [B]
    (``_pair_pstep_labeled``)."""
    V = _valid(nx, ny, Ax.shape[1], Ay.shape[1], Ax.device)
    s = _label_mask(Lx, Ly, V)
    total = mu[0] * _sum2(V * V)
    P = V
    with full_fp32():
        for k in mu[1:]:
            P = s * (Ax @ (P * s) @ Ay.transpose(1, 2))
            total = total + k * _sum2(V * P)
    return total


def pair_baseline_labeled(Ax, Ay, Lx, Ly, nx, ny, lamda, exponential):
    """The labeled baseline on the product-graph weight ``W = D_s (Ax (x)
    Ay) D_s``: ``b^T expm(lamda W) b`` or ``b^T (I - lamda W)^-1 b``,
    f32 [B] (``_pair_baseline_labeled``)."""
    V = _valid(nx, ny, Ax.shape[1], Ay.shape[1], Ax.device)
    s = _label_mask(Lx, Ly, V).reshape(V.shape[0], -1)
    W = _kron(Ax, Ay) * s[:, :, None] * s[:, None, :]
    b = V.reshape(V.shape[0], -1)
    with full_fp32():
        if exponential:
            S = torch.linalg.matrix_exp(lamda * W)
            return (b * (S @ b[:, :, None])[:, :, 0]).sum(1)
        A = torch.eye(W.shape[1], dtype=W.dtype, device=W.device) \
            - lamda * W
        return (b * torch.linalg.solve(A, b)).sum(1)

