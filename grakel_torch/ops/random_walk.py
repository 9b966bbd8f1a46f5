"""Random-walk pair programs on tensors.

The counterpart of the pair numerics of
``grakel_tpu/kernels/random_walk.py`` (:48-233, XLA programs there,
vmapped over chunks of graph pairs).

Two of them are hand-written kernels on a card:

* K8 (``csrc/rw_cg.cu``), :func:`pair_cg`: the fast geometric kernel of
  a pair, 20 conjugate-gradient steps on ``(I - lamda Ax (x) Ay) x = 1``
  in matrix form, the sum of x; with labels, the matvec of
  ``RandomWalkLabeled``.  Its inputs are graph tables, each graph packed
  once (:func:`cg_table`), and a list of pairs of table rows.  Three
  routes, picked from the buckets alone (:func:`cg_route`): "warp" (one
  warp a pair, both buckets up to 32), "shared" and "global" (one block
  a pair).  Its plain version :func:`pair_cg_plain` gathers the pairs
  from the tables and runs :func:`pair_cg_batch`, the JAX package's
  ``_cg_sum`` batched in torch: the fixed loop, the per-pair freeze
  ``sqrt(rs) <= rtol ||b||`` and the zero-denominator guards.
* K9 (``csrc/rw_spectral.cu``), :func:`spectral_gram`: the closed-form
  geometric kernel of every pair of a Gram from each graph's eigenvalues
  and squared eigenvector sums (``_rw_spectral_tile``), evaluated in f64
  from the f32 spectra, in one launch over the tiles of a
  :func:`spectral_plan` (graphs ordered by size; a symmetric Gram's
  tiles on or above the diagonal only).  Its plain version
  :func:`spectral_gram_plain` runs :func:`spectral_tile_plain`, the same
  arithmetic in torch, over the same plan.

The p-step and exponential spectral forms and the dense baselines
(Kronecker product, then a solve or a matrix exponential) are library
work, as in the JAX package: torch calls on the tensors' device, in f32,
on batches of pairs of padded graphs (``Ax`` [B, V1, V1], ``Ay`` [B, V2,
V2] with their valid sizes ``nx``, ``ny``; a graph's vertices are its
first n rows) or per-graph spectra.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gram import full_fp32

__all__ = ["bucket", "cg_table", "pair_cg", "pair_cg_plain",
           "pair_cg_batch", "pair_cg_cuda", "cg_route", "k8_smem_bytes",
           "k8_global_grid", "SpectralPlan", "spectral_plan",
           "pack_spectra", "padded_spectra", "spectral_gram",
           "spectral_gram_plain", "spectral_gram_cuda",
           "spectral_tile_plain", "pair_spectral",
           "pair_pstep", "pair_pstep_labeled", "pair_baseline_geometric",
           "pair_baseline_exponential", "pair_baseline_labeled",
           "CG_ITERS", "CG_RTOL", "CG_PLAIN_CHUNK", "K8_WARP_MAX",
           "K9_TILE"]

CG_ITERS = 20      # the reference's maxiter
CG_RTOL = 1e-6     # the reference's rtol
CG_PLAIN_CHUNK = 512   # pairs a batch of the plain CG (the JAX vmap chunk)

# K8: both buckets at most this take the "warp" route (a lane a column of
# the pair's n1 x n2 matrices).  Above, a block a pair: "shared" while
# every matrix of the pair fits a block's shared memory, else "global"
# (its matrices in a global scratch of one slot a block).  The largest
# shared memory a block may ask for on an H100.
K8_WARP_MAX = 32
K8_SMEM_MAX = 232448
_K8_TILE = 32
_K8_FIXED = 2 * _K8_TILE * (_K8_TILE + 1) * 4 + 2 * 32 * 4
# blocks of the global route at most (two resident a streaming
# multiprocessor), and the share of the card's free memory its scratch
# may take; fewer blocks each loop over more pairs
K8_GLOBAL_BLOCKS = 264
K8_SCRATCH_SHARE = 0.25

# K9: graphs a side of a plan tile at most (a block's 32 x 32 pairs); the
# largest |lamda| it takes (its divisions are __ddiv_rn's, bit for bit,
# for f32 spectra and such lamda: csrc/rw_spectral.cu)
K9_TILE = 32
K9_LAMDA_MAX = 2.0 ** 64


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

def cg_table(adjs, V, labels=None):
    """The graph table of one bucket for :func:`pair_cg`, numpy: f32
    adjacencies [G, V, V] (zero past each graph's size), int32 sizes [G]
    and, with ``labels`` (a sequence of int label-id sequences, one id a
    vertex), int32 labels [G, V] (-1 past the size).  With labels each
    graph's vertices are sorted by label (stable) and its adjacency is
    permuted to match, so every label is a contiguous range of vertices,
    as K8's warp route needs; a kernel value is invariant under a vertex
    permutation.  Returns (A, n, L), L None without labels."""
    G = len(adjs)
    A = np.zeros((G, V, V), np.float32)
    n = np.zeros(G, np.int32)
    L = None if labels is None else np.full((G, V), -1, np.int32)
    for g, a in enumerate(adjs):
        a = np.asarray(a, np.float32)
        k = a.shape[0]
        n[g] = k
        if labels is not None:
            lab = np.asarray(labels[g], np.int64)
            perm = np.argsort(lab, kind="stable")
            a = a[np.ix_(perm, perm)]
            L[g, :k] = lab[perm]
        A[g, :k, :k] = a
    return A, n, L


def pair_cg_batch(Ax, Ay, nx, ny, lamda, Lx=None, Ly=None, n_labels=0,
                  iters=CG_ITERS, rtol=CG_RTOL, return_steps=False):
    """[B] in ``Ax``'s float type (f32 on the paths): for each pair of a
    batch of padded pairs, ``sum(x)`` after ``iters`` CG steps on
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


def pair_cg_plain(Gx, Gy, nx, ny, ia, ib, lamda, Lx=None, Ly=None,
                  n_labels=0, iters=CG_ITERS, rtol=CG_RTOL,
                  return_steps=False):
    """:func:`pair_cg_batch` on the pairs ``(ia[k], ib[k])`` of two graph
    tables (:func:`cg_table`: ``Gx`` [Gx, V1, V1], ``nx`` [Gx], ``Lx``
    [Gx, V1]; ``Gy``, ``ny``, ``Ly`` likewise): gathers
    :data:`CG_PLAIN_CHUNK` pairs at a time (read at call time) and runs
    the batched loop on them.  Returns [B] (and the steps with
    ``return_steps``)."""
    ia = ia.to(torch.int64)
    ib = ib.to(torch.int64)
    chunk = CG_PLAIN_CHUNK
    vals, steps = [], []
    for lo in range(0, int(ia.shape[0]), chunk):
        a, b = ia[lo:lo + chunk], ib[lo:lo + chunk]
        v, s = pair_cg_batch(Gx[a], Gy[b], nx[a], ny[b], lamda,
                             None if Lx is None else Lx[a],
                             None if Ly is None else Ly[b], n_labels,
                             iters, rtol, return_steps=True)
        vals.append(v)
        steps.append(s)
    if not vals:
        vals = [torch.zeros(0, dtype=Gx.dtype, device=Gx.device)]
        steps = [torch.zeros(0, dtype=torch.int64, device=Gx.device)]
    vals, steps = torch.cat(vals), torch.cat(steps)
    return (vals, steps) if return_steps else vals


def k8_smem_bytes(V1, V2, labeled):
    """Dynamic shared memory of a K8 block on the shared route at buckets
    V1, V2: the GEMM staging tiles and reduction slots, both adjacencies,
    the five [V1, V2] CG matrices, and the labels."""
    return (_K8_FIXED + 4 * (V1 * V1 + V2 * V2 + 5 * V1 * V2)
            + (4 * (V1 + V2) if labeled else 0))


def cg_route(V1, V2, labeled):
    """K8's route at buckets V1, V2, from the shapes alone: "warp" when
    both are at most :data:`K8_WARP_MAX` (32); else "shared" when a
    pair's matrices fit a block's shared memory (V1 = V2 = 64 does),
    else "global"."""
    if V1 <= K8_WARP_MAX and V2 <= K8_WARP_MAX:
        return "warp"
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


def pair_cg_cuda(Gx, Gy, nx, ny, ia, ib, lamda, Lx=None, Ly=None,
                 iters=CG_ITERS, rtol=CG_RTOL):
    """Launch K8 (``csrc/rw_cg.cu``): :func:`pair_cg_plain` on a card,
    every step of every pair in one launch.  Graph tables ``Gx`` [Gx,
    V1, V1], ``Gy`` [Gy, V2, V2] contiguous f32, sizes ``nx`` [Gx], ``ny``
    [Gy] int32 (1 <= n <= V), pairs ``ia``, ``ib`` int32 [B] (rows of
    the tables), labels (``Lx`` [Gx, V1], ``Ly`` [Gy, V2] int32 ids >= 0
    on the valid vertices, each graph's ascending as :func:`cg_table`
    leaves them; no label count is needed) on one CUDA device.  The
    route is :func:`cg_route`'s.  Returns f32 [B]."""
    from .. import _build
    dev = Gx.device
    V1 = Gx.shape[1] if Gx.dim() == 3 else 0
    V2 = Gy.shape[1] if Gy.dim() == 3 else 0
    B = ia.shape[0] if ia.dim() == 1 else -1
    labeled = Lx is not None
    if not (dev.type == "cuda" and _f32(Gx, dev, (Gx.shape[0], V1, V1))
            and _f32(Gy, dev, (Gy.shape[0], V2, V2))
            and _i32(nx, dev, (Gx.shape[0],))
            and _i32(ny, dev, (Gy.shape[0],)) and _i32(ia, dev, (B,))
            and _i32(ib, dev, (B,)) and 0 < V1 <= 4096 and 0 < V2 <= 4096
            and (Ly is not None) == labeled
            and (not labeled or (_i32(Lx, dev, (Gx.shape[0], V1))
                                 and _i32(Ly, dev, (Gy.shape[0], V2))))):
        raise ValueError("pair_cg_cuda: need contiguous tensors on one CUDA "
                         "device: f32 tables Gx [Gx, V1, V1] and Gy [Gy, V2, "
                         "V2] (V <= 4096), int32 sizes nx [Gx], ny [Gy], "
                         "int32 pairs ia, ib [B], and int32 Lx [Gx, V1], Ly "
                         "[Gy, V2] together or neither")
    route = cg_route(V1, V2, labeled)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lx = Lx.data_ptr() if labeled else None
    ly = Ly.data_ptr() if labeled else None
    if route == "warp":
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _build.launch("grakel_rw_cg_warp", dev, Gx.data_ptr(),
                      Gy.data_ptr(), nx.data_ptr(), ny.data_ptr(), lx, ly,
                      ia.data_ptr(), ib.data_ptr(), out.data_ptr(), B, V1,
                      V2, float(lamda), int(iters), float(rtol),
                      counter.data_ptr())
    else:
        if route == "shared":
            scratch, grid = None, B
            smem = k8_smem_bytes(V1, V2, labeled)
        else:
            grid = k8_global_grid(B, V1, V2,
                                  torch.cuda.mem_get_info(dev)[0])
            scratch = torch.empty(grid * 5 * V1 * V2, dtype=torch.float32,
                                  device=dev)
            smem = _K8_FIXED
        _build.launch("grakel_rw_cg", dev, Gx.data_ptr(), Gy.data_ptr(),
                      nx.data_ptr(), ny.data_ptr(), lx, ly, ia.data_ptr(),
                      ib.data_ptr(), out.data_ptr(), B, V1, V2,
                      float(lamda), int(iters), float(rtol),
                      None if scratch is None else scratch.data_ptr(), grid,
                      smem)
    pair_cg_cuda.launches += 1
    pair_cg_cuda.route_launches[route] += 1
    return out


pair_cg_cuda.launches = 0
pair_cg_cuda.route_launches = {"warp": 0, "shared": 0, "global": 0}


def pair_cg(Gx, Gy, nx, ny, ia, ib, lamda, Lx=None, Ly=None, n_labels=0):
    """:func:`pair_cg_plain` for CPU tensors, K8 for CUDA ones."""
    dev = Gx.device
    if dev.type == "cpu":
        return pair_cg_plain(Gx, Gy, nx, ny, ia, ib, lamda, Lx, Ly,
                             n_labels)
    if dev.type != "cuda":
        raise ValueError("pair_cg: unsupported device %s" % dev)
    i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
    return pair_cg_cuda(Gx.contiguous(), Gy.contiguous(), i32(nx), i32(ny),
                        i32(ia), i32(ib), lamda, i32(Lx), i32(Ly))


# --------------------------------------------------------------------- #
# K9: the spectral Gram
# --------------------------------------------------------------------- #

class SpectralPlan(NamedTuple):
    """K9's tile plan of one Gram.  ``order_r`` / ``order_c`` (int64)
    give the input row / column at each plan position: the graphs in
    ascending size (so by bucket, and by size within one), stably.
    ``tiles`` (int32 [T, 4]) holds each tile's plan-position ranges
    ``r0, r1, c0, c1``, at most :data:`K9_TILE` a side on the card,
    heaviest first; a symmetric plan keeps only the tiles on or above
    the diagonal of the whole ordered Gram, so every unordered pair of
    graphs lies in one tile (a diagonal tile's entries below its
    diagonal are its mirror)."""
    order_r: np.ndarray
    order_c: np.ndarray
    tiles: np.ndarray
    symmetric: bool


def spectral_plan(n_rows, n_cols, symmetric, tile=K9_TILE):
    """The :class:`SpectralPlan` of a Gram of graphs of sizes ``n_rows``
    against ``n_cols`` (ignored, the rows', when ``symmetric``): square
    tiles of ``tile`` plan positions, ordered by their padded work
    (rows x columns x the largest row and column sizes), largest
    first."""
    n_rows = np.asarray(n_rows, np.int64)
    n_cols = n_rows if symmetric else np.asarray(n_cols, np.int64)
    order_r = np.argsort(n_rows, kind="stable")
    order_c = order_r if symmetric else np.argsort(n_cols, kind="stable")
    nr, nc = len(order_r), len(order_c)
    R, C = np.meshgrid(np.arange(0, nr, tile), np.arange(0, nc, tile),
                       indexing="ij")
    R, C = R.ravel(), C.ravel()
    if symmetric:
        keep = C >= R
        R, C = R[keep], C[keep]
    tiles = np.stack([R, np.minimum(R + tile, nr), C,
                      np.minimum(C + tile, nc)], 1).astype(np.int32)
    if len(tiles):
        sr, sc = n_rows[order_r], n_cols[order_c]
        work = ((tiles[:, 1] - tiles[:, 0]) * (tiles[:, 3] - tiles[:, 2])
                * sr[tiles[:, 1] - 1] * sc[tiles[:, 3] - 1])
        tiles = tiles[np.argsort(-work, kind="stable")]
    return SpectralPlan(order_r, order_c, tiles.reshape(-1, 4),
                        bool(symmetric))


def pack_spectra(s2, mu, order, device):
    """The spectra of graphs ``order`` (plan order) back to back, as K9
    reads them: f32 ``s2`` and ``mu`` [E] (E the eigenvalues of all of
    them) and int32 offsets [G + 1] (graph g's eigenpairs at
    ``off[g]:off[g + 1]``), on ``device``.  ``s2`` / ``mu`` are sequences
    of per-graph arrays in input order."""
    n = np.array([len(s2[i]) for i in order], np.int64)
    off = np.zeros(len(order) + 1, np.int64)
    np.cumsum(n, out=off[1:])
    if off[-1] >= 1 << 31:
        raise ValueError("pack_spectra: more than 2^31 eigenvalues")
    flat = lambda xs: (np.concatenate([np.asarray(xs[i], np.float32)
                                       for i in order])
                       if len(order) else np.zeros(0, np.float32))
    return tuple(torch.from_numpy(x).to(device) for x in
                 (flat(s2), flat(mu), off.astype(np.int32)))


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


def padded_spectra(spec, lo, hi):
    """Graphs ``lo:hi`` (plan positions) of packed spectra
    (:func:`pack_spectra`) as padded f32 s2, mu [hi - lo, n_max] and their
    int64 sizes."""
    s2, mu, off = spec
    o = off[lo:hi + 1].to(torch.int64)
    n = o[1:] - o[:-1]
    width = int(n.max()) if len(n) else 0
    k = torch.arange(width, device=s2.device)
    valid = k[None, :] < n[:, None]
    idx = torch.where(valid, o[:-1, None] + k[None, :], 0)
    take = lambda x: torch.where(valid, x[idx], 0.0) if x.numel() else \
        torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    return take(s2), take(mu), n


def spectral_gram_plain(rows, cols, plan, lamda):
    """f64 [nr, nc] in input order: :func:`spectral_tile_plain` over
    ``plan``'s tiles (one call a row of tiles: their rows against the
    columns the row's tiles span) on packed spectra ``rows`` / ``cols``
    (:func:`pack_spectra` in the plan's orders).  A symmetric plan's
    entries come from the positions on or above the diagonal: a diagonal
    tile's lower entries are its upper ones, mirrored in plan order, and
    every computed entry fills its mirror, as K9 writes them."""
    dev = rows[0].device
    nr, nc = len(plan.order_r), len(plan.order_c)
    out = torch.zeros((nr, nc), dtype=torch.float64, device=dev)
    order_r = torch.from_numpy(plan.order_r).to(dev)
    order_c = torch.from_numpy(plan.order_c).to(dev)
    strips = {}
    for r0, r1, c0, c1 in plan.tiles.tolist():
        lo, hi = strips.get((r0, r1), (c0, c1))
        strips[(r0, r1)] = (min(lo, c0), max(hi, c1))
    for (r0, r1), (c0, c1) in sorted(strips.items()):
        sx, mx, n1 = padded_spectra(rows, r0, r1)
        sy, my, n2 = padded_spectra(cols, c0, c1)
        T = spectral_tile_plain(sx, mx, n1, sy, my, n2, lamda)
        ri, ci = order_r[r0:r1], order_c[c0:c1]
        if plan.symmetric:
            # the strip starts at its diagonal tile (c0 == r0)
            d = r1 - r0
            D = T[:, :d]
            T[:, :d] = torch.triu(D) + torch.triu(D, 1).T
            out[ci[:, None], ri[None, :]] = T.T
        out[ri[:, None], ci[None, :]] = T
    return out


def spectral_gram_cuda(rows, cols, plan, lamda):
    """Launch K9 (``csrc/rw_spectral.cu``): :func:`spectral_gram_plain` on
    a card, one launch over every tile of ``plan`` (at most
    :data:`K9_TILE` a side), one block a tile, for |lamda| up to
    :data:`K9_LAMDA_MAX` (NaN lamda refused).  ``rows`` / ``cols``:
    packed spectra (:func:`pack_spectra`: f32 s2, mu [E], int32 offsets
    [G + 1]) in the plan's orders, on one CUDA device (``cols`` may be
    ``rows``).  Returns the f64 [nr, nc] Gram in input order."""
    from .. import _build

    def ok(spec, G):
        if len(spec) != 3:
            return False
        s2, mu, off = spec
        return (s2.dim() == 1 and _f32(s2, dev, tuple(s2.shape))
                and _f32(mu, dev, tuple(s2.shape))
                and _i32(off, dev, (G + 1,)))
    dev = rows[0].device
    nr, nc = len(plan.order_r), len(plan.order_c)
    t = plan.tiles
    if not (dev.type == "cuda" and ok(rows, nr) and ok(cols, nc)
            and abs(float(lamda)) <= K9_LAMDA_MAX
            and (not plan.symmetric or nr == nc)
            and t.ndim == 2 and t.shape[1] == 4
            and (not len(t) or (
                (t[:, 0] >= 0).all() and (t[:, 0] < t[:, 1]).all()
                and (t[:, 1] <= nr).all() and (t[:, 2] >= 0).all()
                and (t[:, 2] < t[:, 3]).all() and (t[:, 3] <= nc).all()
                and (t[:, 1] - t[:, 0] <= K9_TILE).all()
                and (t[:, 3] - t[:, 2] <= K9_TILE).all()))
            and len(t) < 1 << 31):
        raise ValueError("spectral_gram_cuda: need packed spectra (f32 s2, "
                         "mu [E], int32 offsets [G + 1]) on one CUDA device "
                         "for the plan's rows and columns, plan tiles inside "
                         "the Gram of at most %d a side, and |lamda| <= "
                         "2^64" % K9_TILE)
    out = torch.zeros((nr, nc), dtype=torch.float64, device=dev)
    if len(t):
        up = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(dev)
        tiles, ordr = up(t), up(plan.order_r)
        ordc = ordr if plan.symmetric else up(plan.order_c)
        _build.launch("grakel_rw_spectral_gram", dev, rows[0].data_ptr(),
                      rows[1].data_ptr(), rows[2].data_ptr(),
                      ordr.data_ptr(), cols[0].data_ptr(),
                      cols[1].data_ptr(), cols[2].data_ptr(),
                      ordc.data_ptr(), tiles.data_ptr(), len(t),
                      int(plan.symmetric), out.data_ptr(), nc,
                      float(lamda))
        spectral_gram_cuda.launches += 1
    return out


spectral_gram_cuda.launches = 0


def spectral_gram(rows, cols, plan, lamda):
    """:func:`spectral_gram_plain` for CPU tensors, K9 for CUDA ones."""
    dev = rows[0].device
    if dev.type == "cpu":
        return spectral_gram_plain(rows, cols, plan, lamda)
    if dev.type != "cuda":
        raise ValueError("spectral_gram: unsupported device %s" % dev)
    return spectral_gram_cuda(rows, cols, plan, lamda)


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

