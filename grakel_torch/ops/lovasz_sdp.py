"""Batched Lovász-theta SDP and minimum enclosing cones on the device.

The counterpart of ``grakel_tpu/ops/lovasz_sdp.py`` and of the
minimum-enclosing-cone loop of ``grakel_tpu/kernels/lovasz_theta.py``
(``_min_cone_jit``).

The SDP: the primal

    theta(G) = max <J, X>  s.t.  X PSD, tr X = 1,
               X_ij = 0 for every non-adjacent pair i != j

by Douglas-Rachford splitting between the affine set (zero the
off-support entries, shift the diagonal to trace 1) and the PSD cone
(eigenvalue clipping), 300 iterations, over a batch of graphs padded to
one size V.  An iteration is one batched eigendecomposition of the
reflection R = 2X - Y (:func:`sym_eigh`: on a card K14, a batched
Jacobi in ``csrc/lovasz.cu``, up to 128 rows, where
``torch.linalg.eigh`` runs cuSOLVER a matrix at a time, started from
the step before's eigenvectors but every :data:`JACOBI_RESTART`-th
step; on the CPU ``torch.linalg.eigh``, its
plain version) and one launch of K12
(``csrc/lovasz.cu``, plain version :func:`dr_step_plain`), which
rebuilds Z = V diag(max(w, 0)) V^T, steps Y <- Y + Z - X, projects the
next X = proj_affine(Y + J) with its trace, and writes the next R; on a
card the edges go to K12 as bit rows (:func:`edge_bits`, packed once a
solve) and a thread holds a register tile of the graph
(:func:`k12_route`, :func:`k12_tile`).  The dual slack the labelling needs
is (Y - X) / step at the fixed point, with its fixed entries snapped
(diagonal theta - 1, edges -1), as in the JAX package.

The cones: for each sampled subset (the columns A [d, m] of a graph's
orthonormal labelling), the Badoiu-Clarkson minimum-enclosing-ball
iteration c <- c + (far - c)/(k + 2), 400 steps from the first column,
``far`` the first column farthest from c; then the smallest cosine of
a column with the normalized centre.  K13 (``csrc/lovasz.cu``, plain
version :func:`min_cone_plain`) runs every step in one launch, a subset
on a group of lanes as wide as the next power of two at or above its
columns (:func:`k13_plan`).

On a CUDA tensor :func:`sym_eigh`, :func:`dr_step` and
:func:`min_cone` launch their kernels or raise (past 128 rows
:func:`sym_eigh` takes ``torch.linalg.eigh`` on the card); the plain
versions serve CPU tensors.  All f32, as
the JAX programs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["lovasz_theta_batch", "dr_step", "dr_step_plain",
           "dr_step_cuda", "edge_bits", "min_cone", "min_cone_plain",
           "min_cone_cuda", "sym_eigh", "jacobi_eigh_cuda", "proj_affine",
           "k12_route", "k12_tile", "k13_route", "k13_plan", "k13_slot",
           "k13_smem", "cone_reciprocals", "min_cone_quotient_check",
           "K12_TILES", "K13_REG_D", "K13_SMEM_BUDGET", "K13_SMEM_MAX",
           "MEC_ITERS", "JACOBI_MAX_V", "JACOBI_RESTART"]

MEC_ITERS = 400
# K14 holds a matrix and its eigenvector rows in shared memory: up to
# 128 rows
JACOBI_MAX_V = 128
JACOBI_SWEEPS = 16
# the DR loop starts K14 from the identity every this many steps, from
# the step before's eigenvectors otherwise: each warm call's rotations
# add to U's drift from orthogonality (the checks allow 1e-4), and a
# restart every 100 steps halves the drift at the 64-row buckets
# (chip_smoke.py measures it with and without restarts; PERF.md)
JACOBI_RESTART = 100
# K12's route "tile" by padded size V: (R, G), each thread an R x R
# register tile of the graph, (V / R)^2 threads a graph and G graphs a
# block (128 threads up to V = 32, a graph of 256 past)
K12_TILES = {4: (2, 32), 8: (2, 8), 16: (4, 8), 32: (4, 2), 64: (4, 1),
             128: (8, 1)}
# K13's register route: each lane's column padded with zero rows to the
# first of these at or above d
K13_REG_D = (8, 16, 24, 32, 40, 48, 56, 64, 96, 128)
K13_WARPS = 4
# K13 stages its block's subset columns in shared memory (route "shared")
# within this budget past the register route; larger subsets read them
# from device memory (route "global")
K13_SMEM_BUDGET = 96 * 1024
# the most shared memory a block of an H100 can have
K13_SMEM_MAX = 227 * 1024


def k12_route(V):
    """K12's route for padded size ``V``: "tile" for the sizes of
    :data:`K12_TILES` (powers of two from 4 to 128: a graph's
    eigenvectors staged in shared memory, each thread a register tile),
    else "global" (a block a graph, the eigenvectors read from device
    memory)."""
    return "tile" if V in K12_TILES else "global"


def k12_tile(V):
    """K12's route "tile" at padded size ``V``: ``(R, threads a graph,
    graphs a block, threads a block)``, each thread an R x R tile of
    the graph's Z, Y and X."""
    R, G = K12_TILES[V]
    T = (V // R) ** 2
    return R, T, G, T * G


def edge_bits(E):
    """The edges E [B, V, V] (an entry > 0 is an edge) as bit rows, int32
    [B, V, ceil(V / 32)]: bit j % 32 of word j // 32 of row (b, i) set
    where E[b, i, j] > 0 (the layout of ``ops.svm_qp.adjacency_bits``).
    K12 reads them; the DR loop packs them once a solve."""
    B, V, _ = E.shape
    W = (V + 31) // 32
    bits = torch.nn.functional.pad((E > 0).to(torch.int64),
                                   (0, 32 * W - V))
    sh = torch.arange(32, dtype=torch.int64, device=E.device)
    words = (bits.view(B, V, W, 32) << sh).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32).contiguous()


def _round4(x):
    return (int(x) + 3) & ~3


def k13_slot(d, m, group, route):
    """Floats of a K13 subset's slot in shared memory (``cone_slot`` in
    ``csrc/lovasz.cu``): its centre (padded with zero rows to the
    register width on route "register", to a multiple of four floats
    otherwise), on routes "register" and "shared" its columns [m, d]
    (rounded up to four floats), then padding to the next float that
    lies ``group`` banks (4 for a group of 1 or 2) past a multiple of
    32, so the group's lanes fall in distinct banks."""
    cp = _k13_reg_d(d) if route == "register" else _round4(d)
    slot = cp + (_round4(d * m) if route != "global" else 0)
    if group < 32:
        off = max(group, 4)
        slot += (off + 32 - slot % 32) % 32
    return slot


def k13_smem(d, m, group, route):
    """Shared memory of a K13 block (four warps, 32 / ``group`` subsets
    a warp, a :func:`k13_slot` each) on ``route``, in bytes."""
    return K13_WARPS * (32 // group) * k13_slot(d, m, group, route) * 4


def _k13_reg_d(d):
    return next(r for r in K13_REG_D if r >= d)


def k13_plan(d, m, route=None):
    """K13's launch for subsets of ``m`` (1..32) columns of length ``d``:
    ``(route, group, reg_d, smem)``.  ``route`` (default
    :func:`k13_route`): "register" (d <= the widest of
    :data:`K13_REG_D`), "shared" or "global".  ``group``: the lanes a
    subset, the next power of two at or above m (32 / group subsets a
    warp), widened where the block's shared memory
    (:func:`k13_smem`) would pass :data:`K13_SMEM_MAX`; ``reg_d``: the
    register width (0 off route "register")."""
    route = route or k13_route(d, m)
    if route == "register" and d > K13_REG_D[-1]:
        raise ValueError("k13_plan: route register takes d <= %d"
                         % K13_REG_D[-1])
    if route not in ("register", "shared", "global"):
        raise ValueError("k13_plan: unknown route %r" % (route,))
    group = 1 << (int(m) - 1).bit_length()
    while group < 32 and k13_smem(d, m, group, route) > K13_SMEM_MAX:
        group *= 2
    smem = k13_smem(d, m, group, route)
    if smem > K13_SMEM_MAX:
        raise ValueError("k13_plan: subsets of %d x %d do not fit a block "
                         "on route %s" % (d, m, route))
    return route, group, _k13_reg_d(d) if route == "register" else 0, smem


def k13_route(d, m):
    """K13's route for subsets of ``m`` columns of length ``d``:
    "register" while d fits the widest register column
    (:data:`K13_REG_D`), else "shared" while the block's columns and
    centres fit :data:`K13_SMEM_BUDGET`, else "global"."""
    if d <= K13_REG_D[-1]:
        return "register"
    group = 1 << (int(m) - 1).bit_length()
    return ("shared" if k13_smem(d, m, group, "shared") <= K13_SMEM_BUDGET
            else "global")


def _masks(E, n):
    """(J, dvalid, keep, nvalid) of a padded batch: J the n x n block of
    ones, dvalid its diagonal, keep the support of X (edges and the
    valid diagonal), nvalid max(n, 1) [B, 1, 1]."""
    B, V, _ = E.shape
    valid = (torch.arange(V, device=E.device)[None, :]
             < n.to(E.device)[:, None]).to(E.dtype)
    J = valid[:, :, None] * valid[:, None, :]
    dvalid = torch.diag_embed(valid)
    keep = (E > 0) | (dvalid > 0)
    nvalid = torch.clamp(valid.sum(1), min=1.0)[:, None, None]
    return J, dvalid, keep, nvalid


def proj_affine(M, dvalid, keep, nvalid):
    """Zero M off the support, then shift its valid diagonal to trace
    1."""
    X = torch.where(keep, M, torch.zeros_like(M))
    tr = torch.diagonal(X, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    return X + (1.0 - tr) / nvalid * dvalid


def _proj_psd(M):
    w, U = sym_eigh(M)
    w = torch.clamp(w, min=0.0)
    return (U * w[..., None, :]) @ U.transpose(-1, -2)


# --------------------------------------------------------------------- #
# K14: the eigendecomposition; K12: one Douglas-Rachford step around it
# --------------------------------------------------------------------- #

def jacobi_eigh_cuda(M, U0=None, max_sweeps=JACOBI_SWEEPS, sweeps=None):
    """Launch K14 (``csrc/lovasz.cu``): the eigenpairs of the symmetric
    matrices M [B, V, V] (contiguous f32 on a CUDA device, V a power of
    two, 2 <= V <= :data:`JACOBI_MAX_V`; the lower triangles are read, as
    ``torch.linalg.eigh`` reads them) by cyclic Jacobi, a warp a matrix
    up to 16 rows, a block past.  Returns (w [B, V], U [B, V, V]) with M
    = U diag(w) U^T: the eigenvalues unsorted, U column-major (a
    transposed view of the kernel's eigenvector rows, the layout
    :func:`dr_step_cuda` takes).

    ``U0``: a start basis in that same layout (an earlier call's U: an
    orthogonal [B, V, V] whose transpose is contiguous); the sweeps then
    run on U0^T M U0 and their rotations accumulate into U0, so a basis
    that nearly diagonalizes M leaves few sweeps.  ``sweeps``: an int32
    [B] tensor on the device that takes each matrix's sweep count."""
    from .. import _build
    dev = M.device
    B = M.shape[0] if M.dim() == 3 else -1
    V = M.shape[-1] if M.dim() == 3 else 0
    if not (dev.type == "cuda" and _f32(M, dev, (B, V, V))
            and 2 <= V <= JACOBI_MAX_V and V & (V - 1) == 0
            and max_sweeps >= 0):
        raise ValueError("jacobi_eigh_cuda: need a contiguous f32 M [B, V, "
                         "V] on a CUDA device, V a power of two, 2 <= V <= "
                         "%d" % JACOBI_MAX_V)
    U0t = None
    if U0 is not None:
        U0t = U0.transpose(-1, -2) if U0.dim() == 3 else U0
        if not _f32(U0t, dev, (B, V, V)):
            raise ValueError("jacobi_eigh_cuda: U0 must be an f32 [B, V, V] "
                             "on M's device whose transpose is contiguous "
                             "(the U an earlier call returned)")
    if sweeps is not None and not (
            sweeps.device == dev and sweeps.dtype == torch.int32
            and tuple(sweeps.shape) == (B,) and sweeps.is_contiguous()):
        raise ValueError("jacobi_eigh_cuda: sweeps must be a contiguous "
                         "int32 [B] on M's device")
    w = torch.empty((B, V), dtype=torch.float32, device=dev)
    Ut = torch.empty((B, V, V), dtype=torch.float32, device=dev)
    if B:
        _build.launch("grakel_lovasz_jacobi_eigh", dev, M.data_ptr(),
                      None if U0t is None else U0t.data_ptr(), w.data_ptr(),
                      Ut.data_ptr(),
                      None if sweeps is None else sweeps.data_ptr(), B, V,
                      int(max_sweeps))
        jacobi_eigh_cuda.launches += 1
    return w, Ut.transpose(-1, -2)


jacobi_eigh_cuda.launches = 0


def sym_eigh(M, U0=None):
    """Eigenpairs (w, U) of the symmetric f32 matrices M [B, V, V]:
    ``torch.linalg.eigh`` (the plain version) for CPU tensors, K14 for
    CUDA ones of a power-of-two size up to :data:`JACOBI_MAX_V` rows
    (LovaszTheta's buckets), started from ``U0`` when given,
    ``torch.linalg.eigh`` otherwise (which ignores ``U0``)."""
    V = M.shape[-1]
    if M.device.type == "cuda" and 2 <= V <= JACOBI_MAX_V \
            and V & (V - 1) == 0:
        return jacobi_eigh_cuda(M.contiguous(), U0)
    return torch.linalg.eigh(M)


def dr_step_plain(E, n, Y, X, w, U, step=1.0):
    """One DR iteration given eigh(2X - Y) = (w, U): Z = U diag(max(w,
    0)) U^T, Y' = Y + Z - X, X' = proj_affine(Y' + step J) and R' = 2X' -
    Y'.  E [B, V, V] f32 edges (0/1, zero diagonal, zero outside the n x
    n block), n [B] sizes.  Returns (Y', X', R')."""
    J, dvalid, keep, nvalid = _masks(E, n)
    Z = (U * torch.clamp(w, min=0.0)[:, None, :]) @ U.transpose(-1, -2)
    Y = Y + Z - X
    X = proj_affine(Y + step * J, dvalid, keep, nvalid)
    return Y, X, 2.0 * X - Y


def _f32(t, dev, shape):
    return (t.device == dev and t.dtype == torch.float32
            and tuple(t.shape) == shape and t.is_contiguous())


def dr_step_cuda(Eb, n, Y, X, w, U, step=1.0, route=None):
    """Launch K12 (``csrc/lovasz.cu``): :func:`dr_step_plain` on a card,
    in place: Y and X take Y' and X', and R' is returned (all of it).
    Eb: the edges as bit rows (:func:`edge_bits`, int32 [B, V, ceil(V /
    32)]); Y, X [B, V, V], w [B, V] contiguous f32, n [B] int32 and the
    eigenvectors U [B, V, V] f32 whose transpose is contiguous (the
    column-major U K14 and ``torch.linalg.eigh`` return on a card; the
    kernel reads the eigenvectors as rows), on one CUDA device, V <=
    4096.  ``route`` ("tile" / "global", default :func:`k12_route`)
    overrides the route, for measurements; route "tile" takes the sizes
    of :data:`K12_TILES` and 16-byte aligned Y, X and U."""
    from .. import _build
    dev = Y.device
    B = Y.shape[0] if Y.dim() == 3 else -1
    V = Y.shape[1] if Y.dim() == 3 else 0
    Ut = U.transpose(-1, -2)
    if not (dev.type == "cuda" and 0 < V <= 4096
            and all(_f32(t, dev, (B, V, V)) for t in (Y, X, Ut))
            and _f32(w, dev, (B, V)) and n.device == dev
            and n.dtype == torch.int32 and tuple(n.shape) == (B,)
            and Eb.device == dev and Eb.dtype == torch.int32
            and tuple(Eb.shape) == (B, V, (V + 31) // 32)
            and Eb.is_contiguous()):
        raise ValueError("dr_step_cuda: need int32 edge bit rows Eb [B, V, "
                         "ceil(V / 32)], contiguous f32 Y, X [B, V, V], a "
                         "column-major f32 U [B, V, V] (a contiguous "
                         "transpose), f32 w [B, V] and int32 n [B] on one "
                         "CUDA device (V <= 4096)")
    route = route or k12_route(V)
    if route == "tile":
        if V not in K12_TILES or any(
                t.data_ptr() % 16 for t in (Y, X, Ut)):
            raise ValueError("dr_step_cuda: route tile takes V in %s and "
                             "16-byte aligned Y, X and U"
                             % sorted(K12_TILES))
        tile_r, _, graphs, _ = k12_tile(V)
    elif route == "global":
        tile_r, graphs = 0, 1
    else:
        raise ValueError("dr_step_cuda: unknown route %r" % (route,))
    R = torch.empty_like(Y)
    if B:
        _build.launch("grakel_lovasz_dr_step", dev, Eb.data_ptr(),
                      n.data_ptr(), Y.data_ptr(), X.data_ptr(), w.data_ptr(),
                      Ut.data_ptr(), R.data_ptr(), B, V, float(step), tile_r,
                      graphs)
        dr_step_cuda.launches += 1
        dr_step_cuda.route_launches[route] += 1
    return R


dr_step_cuda.launches = 0
dr_step_cuda.route_launches = {"tile": 0, "global": 0}


def dr_step(E, n, Y, X, w, U, step=1.0, Eb=None):
    """One DR step: :func:`dr_step_plain` for CPU tensors, K12 (in
    place) for CUDA ones, on the edges' bit rows ``Eb`` (packed from E
    when not given).  Returns (Y', X', R')."""
    if E.device.type == "cpu":
        return dr_step_plain(E, n, Y, X, w, U, step)
    if E.device.type != "cuda":
        raise ValueError("dr_step: unsupported device %s" % E.device)
    Ut = U.transpose(-1, -2).contiguous()
    R = dr_step_cuda(edge_bits(E) if Eb is None else Eb, n, Y, X,
                     w.contiguous(), Ut.transpose(-1, -2), step)
    return Y, X, R


def _theta(E, n, iters, step):
    """theta [B] and the snapped dual slack S [B, V, V] (the JAX
    package's ``_theta_impl``).  On a card each step's eigendecomposition
    starts from the step before's eigenvectors (the reflection moves
    little from one step to the next), every :data:`JACOBI_RESTART`-th
    one (the first among them) and theta's from the identity."""
    J, dvalid, keep, nvalid = _masks(E, n)
    Y = torch.zeros_like(E)
    X = proj_affine(Y + step * J, dvalid, keep, nvalid)
    R = 2.0 * X - Y
    U = None
    Eb = edge_bits(E) if E.device.type == "cuda" else None
    for k in range(iters):
        w, U = sym_eigh(R, U if k % JACOBI_RESTART else None)
        Y, X, R = dr_step(E, n, Y, X, w, U, step, Eb=Eb)
    theta = (J * _proj_psd(X)).sum((-2, -1))
    S = (Y - X) / step
    V = E.shape[-1]
    eye = torch.eye(V, dtype=E.dtype, device=E.device)[None]
    S = torch.where(dvalid > 0, theta[:, None, None] - 1.0, S)
    S = torch.where(E > 0, -torch.ones_like(S), S)
    S = torch.where(J > 0, S, eye.expand_as(S))
    return theta, S


def lovasz_theta_batch(adjs, ns, iters=300, step=1.0, device=None):
    """theta + PSD dual slack S for a batch of graphs padded to equal
    size, on ``device`` (default: the ambient device, else cuda).

    adjs: [B, V, V] 0/1 adjacency (symmetric); ns: [B] true sizes.
    Returns numpy (theta [B], S [B, V, V]) with S's fixed entries
    snapped (diag = theta - 1, edges = -1); S may carry O(1e-5) negative
    eigenvalues from float32 — downstream Cholesky callers regularize.
    """
    dev = resolve_device(device)
    adjs = np.asarray(adjs)
    B, V, _ = adjs.shape
    E = (adjs > 0).astype(np.float32)
    for b in range(B):
        np.fill_diagonal(E[b], 0.0)
    ns = np.asarray(ns, np.int64)
    inside = np.arange(V)[None, :] < ns[:, None]
    E *= inside[:, :, None] & inside[:, None, :]
    t, S = _theta(torch.from_numpy(E).to(dev),
                  torch.from_numpy(ns.astype(np.int32)).to(dev), iters, step)
    return t.cpu().numpy(), S.cpu().numpy()


# --------------------------------------------------------------------- #
# K13: minimum enclosing cones
# --------------------------------------------------------------------- #

def _sq_dist(A, c):
    """d2[s, j] = sum_i (A[s, i, j] - c[s, i])^2 in f32, summed over i
    in order with one rounding a term, as a fused multiply-add does
    (the square of an f32 difference is exact in f64, so the f64 add
    rounded to f32 is the fused result except at double-rounding
    ties).  This is the order XLA-CPU takes for d <= 17 and the order
    of K13, whose argmax it must reproduce: the Badoiu-Clarkson
    iteration meets exact ties in exact arithmetic (two points
    equidistant from their midpoint), so the far column, and with it
    the centre, is decided by the last bit of d2."""
    diff = (A - c[:, :, None]).double()
    sq = diff * diff
    acc = torch.zeros_like(sq[:, 0, :], dtype=torch.float32)
    for i in range(A.shape[1]):
        acc = (acc.double() + sq[:, i, :]).float()
    return acc


def min_cone_plain(A, iters=MEC_ITERS):
    """Badoiu-Clarkson minimum-enclosing-ball centres of the subsets A
    [S, d, m] f32 (``iters`` steps from the first column; ``far`` the
    first farthest column, by :func:`_sq_dist`), normalized, and each
    subset's smallest cosine with its centre: t [S] f32."""
    S, d, m = A.shape
    c = A[:, :, 0].clone()
    # the step's divisor as a device tensor: a Python scalar divisor is a
    # multiplication by its reciprocal on a card (another rounding)
    dens = torch.arange(2, iters + 2, dtype=A.dtype, device=A.device)
    for k in range(iters):
        d2 = _sq_dist(A, c)
        f = torch.argmax(d2, dim=1)
        far = torch.gather(A, 2, f[:, None, None].expand(S, d, 1))[:, :, 0]
        c = c + (far - c) / dens[k]
    nc = torch.linalg.vector_norm(c, dim=1, keepdim=True)
    c = torch.where(nc > 0, c / torch.clamp(nc, min=1e-30),
                    torch.zeros_like(c))
    return torch.einsum("sdm,sd->sm", A, c).min(1).values


def min_cone_cuda(A, iters=MEC_ITERS, route=None):
    """Launch K13 (``csrc/lovasz.cu``): :func:`min_cone_plain` on a
    card, every step in one launch, a subset on a group of lanes
    (:func:`k13_plan`).  A [S, d, m] contiguous f32 on a CUDA device (1
    <= m <= 32, 1 <= d <= 8192); ``route`` ("register" / "shared" /
    "global", default :func:`k13_route`) overrides where the columns are
    read from, for measurements.  Returns t [S] f32."""
    from .. import _build
    dev = A.device
    if not (dev.type == "cuda" and A.dim() == 3
            and A.dtype == torch.float32 and A.is_contiguous()
            and 1 <= A.shape[2] <= 32 and 1 <= A.shape[1] <= 8192):
        raise ValueError("min_cone_cuda: need a contiguous f32 A [S, d, m] "
                         "on a CUDA device (1 <= m <= 32, 1 <= d <= 8192)")
    S, d, m = A.shape
    route, group, reg_d, _ = k13_plan(d, m, route)
    t = torch.empty(S, dtype=torch.float32, device=dev)
    if S:
        _build.launch("grakel_lovasz_min_cone", dev, A.data_ptr(),
                      _cone_reciprocals(int(iters), dev).data_ptr(),
                      t.data_ptr(), S, d, m, int(iters), group, reg_d,
                      int(route != "global"))
        min_cone_cuda.launches += 1
        min_cone_cuda.route_launches[route] += 1
    return t


min_cone_cuda.launches = 0
min_cone_cuda.route_launches = {"register": 0, "shared": 0, "global": 0}


def cone_reciprocals(iters):
    """The f32 reciprocals 1 / (k + 2), k < ``iters``, correctly rounded
    (numpy's IEEE division): K13 divides the centre's step by k + 2 as
    the product with 1 / (k + 2) and two fused corrections, which is the
    IEEE quotient (``min_cone_quotient_check``)."""
    return np.float32(1.0) / np.arange(2, iters + 2, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _cone_reciprocals(iters, device):
    return torch.from_numpy(cone_reciprocals(iters)).to(device)


def min_cone_quotient_check(device, iters=MEC_ITERS):
    """K13's quotient against CUDA's IEEE division (``__fdiv_rn``) bit
    for bit on ``device`` (a CUDA device): every f32 x in [-2, 2] over
    every divisor 2 .. ``iters`` + 1, with the reciprocals of
    :func:`cone_reciprocals`.  One launch; returns (pairs that differ,
    pairs checked, the first difference as (x, divisor) or None)."""
    from .. import _build
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("min_cone_quotient_check: needs a CUDA device")
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    _build.launch("grakel_lovasz_cone_quotient_check", dev,
                  _cone_reciprocals(int(iters), dev).data_ptr(), int(iters),
                  out.data_ptr())
    bad, seen, first = (int(v) & 0xFFFFFFFFFFFFFFFF for v in out.tolist())
    x = np.array([first >> 32], np.uint32).view(np.float32)[0]
    return bad, seen, (float(x), first & 0xFFFFFFFF) if bad else None


def min_cone(A, iters=MEC_ITERS):
    """:func:`min_cone_plain` for CPU tensors, K13 for CUDA ones."""
    if A.device.type == "cpu":
        return min_cone_plain(A, iters)
    if A.device.type != "cuda":
        raise ValueError("min_cone: unsupported device %s" % A.device)
    return min_cone_cuda(A.contiguous(), iters)
