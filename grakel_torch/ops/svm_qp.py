"""Batched one-class SVM dual solve over a whole graph dataset.

The counterpart of ``grakel_tpu/ops/svm_qp.py``.  SvmTheta needs, per
graph, the dual coefficients of ``OneClassSVM(kernel="precomputed")`` on
the binarized adjacency: the solution of

    min_a  1/2 a^T K a   s.t.  0 <= a_i <= 1,  sum a = nu * n,

where K = (A > 1e-10) with zero diagonal, spectrally shifted to be PSD
(K <- K/(-lambda_min) + I when lambda_min < -1e-6).

Graphs bucket by padded size V (a power of two >= 8) and slabs of at
most ``s_cap`` graphs, as in the JAX package (a graph's slab position
seeds its Lanczos start vector, so the slabs are the same).  A bucket
runs:

* per slab, the densify (one ``index_add_`` of the slab's edges into a
  zeroed [S, V, V] f32 tensor on the device; only K10 reads K dense)
  and K10
  (``csrc/svm_qp.cu``, plain version :func:`lanczos_plain`): m = 64
  Lanczos steps without reorthogonalization, alpha and beta [S, m];
* once over the bucket, K's rows as bit masks (:func:`adjacency_bits`,
  one ``index_add_``) and K11 (``csrc/svm_qp.cu``): each graph's warp
  finds the extremal eigenvalues of its [m, m] tridiagonal by Sturm
  counts and takes the spectral shift (scale, dadd, the FISTA step 1/L)
  from them, then runs 300 FISTA iterations on the dual, each projected
  onto {0 <= a <= u, sum a = s} by 30 bisection steps on the simplex
  shift, warm-started at libsvm's own initial point a_i = clip(nu*n -
  i, 0, 1).  Its plain version is :func:`spectral_shift` (one batched
  ``torch.linalg.eigvalsh``) and :func:`fista_plain` on the dense K;
* one fetch of the bucket's alphas.

On a CUDA tensor :func:`lanczos` and :func:`one_class_fista` launch
their kernels or raise; the plain versions serve CPU tensors.  All f32,
as the JAX program (the eigenvalue search in f64, to the f32 rounding).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["one_class_alphas", "lanczos", "lanczos_plain", "lanczos_cuda",
           "one_class_fista", "fista_plain", "fista_cuda", "start_vector",
           "spectral_shift", "shift_from_extremes", "tridiagonal_extremes",
           "adjacency_bits", "dense_from_bits", "fista_momenta", "svm_route",
           "k11_route",
           "SVM_SMEM_BUDGET", "K11_WARP_MAX_V"]

_LANCZOS_M = 64
_FISTA_ITERS = 300
_BISECT_ITERS = 30
_MIN_WEIGHT = 1e-10
_EIG_TOL = 1e-6
_SLAB_BYTES = 1 << 30

# K10 holds a graph's K in shared memory while K and the kernel's
# vectors fit this budget (V <= 128); larger V reads K from device memory
SVM_SMEM_BUDGET = 200 * 1024
# K11 runs a warp a graph up to this padded size, a block a graph past it
K11_WARP_MAX_V = 64


def _pow2(x):
    return max(8, 1 << (max(int(x) - 1, 1)).bit_length())


def svm_route(V):
    """K10's route for padded size ``V``: "shared" while the graph's K
    [V, V] f32 and six f32 vectors of V fit :data:`SVM_SMEM_BUDGET`, else
    "global"."""
    return "shared" if (V * V + 6 * V) * 4 <= SVM_SMEM_BUDGET else "global"


def start_vector(u):
    """The Lanczos start vector before normalization, cos(1.372954 i +
    0.718281 g) u for vertex i of the slab's graph g (the JAX program's,
    in f32)."""
    S, V = u.shape
    i_v = torch.arange(V, dtype=torch.float32, device=u.device)[None, :]
    g_v = torch.arange(S, dtype=torch.float32, device=u.device)[:, None]
    return torch.cos(1.372954 * i_v + 0.718281 * g_v) * u


# --------------------------------------------------------------------- #
# K10: Lanczos
# --------------------------------------------------------------------- #

def lanczos_plain(K, v0, m=_LANCZOS_M):
    """``m`` Lanczos steps of K [S, V, V] f32 from the start vectors v0
    [S, V] (normalized here; a zero row stays zero), no
    reorthogonalization: returns alpha, beta [S, m] f32 (beta_j = 0 where
    the step's residual norm is at most 1e-6, and the next vector is
    then zero)."""
    S, V = v0.shape
    nrm = torch.sqrt((v0 * v0).sum(1, keepdim=True))
    v = v0 * torch.where(nrm > 0, 1.0 / nrm.clamp_min(1e-30),
                         torch.zeros_like(nrm))
    v_prev = torch.zeros_like(v)
    b_prev = torch.zeros(S, dtype=torch.float32, device=K.device)
    al = torch.zeros((S, m), dtype=torch.float32, device=K.device)
    be = torch.zeros((S, m), dtype=torch.float32, device=K.device)
    for j in range(m):
        w = torch.bmm(K, v[:, :, None])[:, :, 0]
        aj = (v * w).sum(1)
        w = w - aj[:, None] * v - b_prev[:, None] * v_prev
        bj = torch.sqrt((w * w).sum(1))
        big = bj > 1e-6
        invb = torch.where(big, 1.0 / bj.clamp_min(1e-30),
                           torch.zeros_like(bj))
        v_prev, v = v, w * invb[:, None]
        b_prev = torch.where(big, bj, torch.zeros_like(bj))
        al[:, j] = aj
        be[:, j] = b_prev
    return al, be


def _f32(t, dev, shape):
    return (t.device == dev and t.dtype == torch.float32
            and tuple(t.shape) == shape and t.is_contiguous())


def lanczos_cuda(K, v0, m=_LANCZOS_M, route=None):
    """Launch K10 (``csrc/svm_qp.cu``): :func:`lanczos_plain` on a card,
    a block a graph, all ``m`` steps in one launch.  K [S, V, V] and v0
    [S, V] contiguous f32 on one CUDA device; ``route`` ("shared" /
    "global", default :func:`svm_route`) overrides the placement of K
    for measurements.  Returns alpha, beta [S, m] f32."""
    from .. import _build
    dev = K.device
    S = K.shape[0] if K.dim() == 3 else -1
    V = K.shape[1] if K.dim() == 3 else 0
    if not (dev.type == "cuda" and _f32(K, dev, (S, V, V))
            and _f32(v0, dev, (S, V)) and 0 < V <= 8192 and m > 0):
        raise ValueError("lanczos_cuda: need contiguous f32 K [S, V, V] "
                         "and v0 [S, V] on one CUDA device (V <= 8192)")
    route = route or svm_route(V)
    al = torch.empty((S, m), dtype=torch.float32, device=dev)
    be = torch.empty((S, m), dtype=torch.float32, device=dev)
    if S:
        _build.launch("grakel_svm_lanczos", dev, K.data_ptr(),
                      v0.data_ptr(), al.data_ptr(), be.data_ptr(), S, V, m,
                      int(route == "shared"))
        lanczos_cuda.launches += 1
        lanczos_cuda.route_launches[route] += 1
    return al, be


lanczos_cuda.launches = 0
lanczos_cuda.route_launches = {"shared": 0, "global": 0}


def lanczos(K, v0, m=_LANCZOS_M):
    """:func:`lanczos_plain` for CPU tensors, K10 for CUDA ones."""
    if K.device.type == "cpu":
        return lanczos_plain(K, v0, m)
    if K.device.type != "cuda":
        raise ValueError("lanczos: unsupported device %s" % K.device)
    return lanczos_cuda(K.contiguous(), v0.contiguous(), m)


# --------------------------------------------------------------------- #
# K11: FISTA with the box-simplex projection
# --------------------------------------------------------------------- #

def fista_plain(K, a0, u, s_target, scale, dadd, L, iters=_FISTA_ITERS,
                bisect=_BISECT_ITERS):
    """``iters`` FISTA steps on min 1/2 a^T Kx a, Kx = scale K + dadd I,
    step 1/L, over {0 <= a <= u, sum a = s_target}, from a0: K [S, V, V],
    a0, u [S, V], s_target, scale, dadd, L [S], all f32.  Returns a [S,
    V] f32."""
    def project(v):
        lo = v.min(1).values - 1.0
        hi = v.max(1).values
        for _ in range(bisect):
            mid = 0.5 * (lo + hi)
            tot = torch.minimum(torch.clamp(v - mid[:, None], min=0.0),
                                u).sum(1)
            over = tot > s_target
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        return torch.minimum(torch.clamp(v - (0.5 * (lo + hi))[:, None],
                                         min=0.0), u)

    a, y = a0, a0
    t = torch.ones((), dtype=torch.float32, device=K.device)
    for _ in range(iters):
        g = scale[:, None] * torch.bmm(K, y[:, :, None])[:, :, 0] \
            + dadd[:, None] * y
        an = project(y - g / L[:, None])
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = an + ((t - 1.0) / tn) * (an - a)
        a, t = an, tn
    return a


def k11_route(V):
    """K11's route for padded size ``V``: "warp" (a warp a graph, K's rows
    as bit masks in registers) up to V = 64, "block" (a block a graph)
    past it."""
    return "warp" if V <= K11_WARP_MAX_V else "block"


def adjacency_bits(flat, S, V, device):
    """K [S, V, V] (0/1) as bit rows: int32 [S, V, ceil(V / 32)], bit j %
    32 of word j // 32 of row (g, i) set where K[g, i, j] = 1.  ``flat``:
    the distinct flat positions g V^2 + i V + j of the ones (numpy
    int64).  One ``index_add_`` on ``device``: each one adds its own bit,
    so the sums are the bitwise or."""
    W = (V + 31) // 32
    g_i, j = np.divmod(np.asarray(flat, np.int64), V)
    words = torch.from_numpy(g_i * W + j // 32).to(device)
    bits = torch.from_numpy(
        np.left_shift(np.uint32(1), (j % 32).astype(np.uint32))
        .view(np.int32)).to(device)
    Kb = torch.zeros(S * V * W, dtype=torch.int32, device=device)
    Kb.index_add_(0, words, bits)
    return Kb.view(S, V, W)


def dense_from_bits(Kb, V):
    """The f32 K [S, V, V] of bit rows ``Kb`` [S, V, ceil(V / 32)]."""
    S, _, W = Kb.shape
    sh = torch.arange(32, dtype=torch.int32, device=Kb.device)
    K = (Kb[:, :, :, None] >> sh) & 1
    return K.reshape(S, V, W * 32)[:, :, :V].to(torch.float32)


def fista_momenta(iters):
    """The FISTA momenta (t_k - 1) / t_{k+1}, k < ``iters``, of
    :func:`fista_plain` (t_0 = 1, t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2),
    in its f32 operations and order, each correctly rounded (as on a
    card and in the JAX program; torch's CPU sqrt can differ in the last
    bit): numpy f32 [iters].  They depend on nothing else, so K11 takes
    them as an input."""
    f = np.float32
    t = f(1.0)
    out = np.empty(iters, np.float32)
    for k in range(iters):
        tn = f(0.5) * (f(1.0) + np.sqrt(f(1.0) + f(4.0) * t * t))
        out[k] = (t - f(1.0)) / tn
        t = tn
    return out


@functools.lru_cache(maxsize=None)
def _momenta_on(iters, device):
    return torch.from_numpy(fista_momenta(iters)).to(device)


def fista_cuda(Kb, a0, u, s_target, al, be, iters=_FISTA_ITERS,
               bisect=_BISECT_ITERS, route=None):
    """Launch K11 (``csrc/svm_qp.cu``): :func:`spectral_shift` and
    :func:`fista_plain` on a card, every iteration and bisection step in
    one launch.  Kb [S, V, ceil(V / 32)] int32, K's bit rows
    (:func:`adjacency_bits`); a0, u [S, V], s_target [S], the Lanczos
    coefficients al, be [S, m], contiguous f32 on one CUDA device.  Each
    graph's warp finds the extremal eigenvalues of its tridiagonal by
    Sturm-count multisection (f64, to the f32 rounding) and takes
    spectral_shift's scale, dadd and L from them; ``route`` ("warp", V
    <= 64, / "block", default :func:`k11_route`) overrides the route for
    measurements.  Returns (a [S, V], lam [S, 2]) f32: the alphas, and
    lambda_min and lambda_max."""
    from .. import _build
    dev = Kb.device
    S = Kb.shape[0] if Kb.dim() == 3 else -1
    V = Kb.shape[1] if Kb.dim() == 3 else 0
    m = al.shape[1] if al.dim() == 2 else 0
    route = route or k11_route(V)
    if not (dev.type == "cuda" and Kb.dtype == torch.int32
            and Kb.is_contiguous() and Kb.dim() == 3
            and Kb.shape[2] == (V + 31) // 32
            and all(_f32(x, dev, (S, V)) for x in (a0, u))
            and _f32(s_target, dev, (S,))
            and all(_f32(x, dev, (S, m)) for x in (al, be))
            and 8 <= V <= 8192 and V & (V - 1) == 0 and m > 0
            and iters >= 0 and bisect >= 0
            and route in ("warp", "block")
            and (route == "block" or V <= K11_WARP_MAX_V)):
        raise ValueError("fista_cuda: need contiguous int32 bit rows Kb [S, "
                         "V, ceil(V / 32)], f32 a0 and u [S, V], s_target "
                         "[S], al and be [S, m] on one CUDA device (V a "
                         "power of two, 8 <= V <= 8192; route warp only up "
                         "to V = %d)" % K11_WARP_MAX_V)
    out = torch.empty((S, V), dtype=torch.float32, device=dev)
    lam = torch.empty((S, 2), dtype=torch.float32, device=dev)
    if S:
        coef = _momenta_on(int(iters), dev)
        _build.launch("grakel_svm_fista", dev, Kb.data_ptr(), a0.data_ptr(),
                      u.data_ptr(), s_target.data_ptr(), al.data_ptr(),
                      be.data_ptr(), coef.data_ptr(), out.data_ptr(),
                      lam.data_ptr(), S, V, m, int(iters), int(bisect),
                      int(route == "warp"))
        fista_cuda.launches += 1
        fista_cuda.route_launches[route] += 1
    return out, lam


fista_cuda.launches = 0
fista_cuda.route_launches = {"warp": 0, "block": 0}


def one_class_fista(Kb, a0, u, s_target, al, be, iters=_FISTA_ITERS):
    """The spectral shift and the FISTA solve of a bucket: K11 for CUDA
    tensors; for CPU ones its plain version, :func:`spectral_shift` and
    :func:`fista_plain` on the dense K of the bit rows ``Kb``, a slab of
    graphs at a time (the solve is per graph; a slab bounds the dense
    K's memory)."""
    if Kb.device.type == "cpu":
        S, V, _ = Kb.shape
        cap = _slab_cap(V)
        out = []
        for s0 in range(0, S, cap):
            sl = slice(s0, s0 + cap)
            out.append(fista_plain(dense_from_bits(Kb[sl], V), a0[sl],
                                   u[sl], s_target[sl],
                                   *spectral_shift(al[sl], be[sl]), iters))
        return torch.cat(out) if out else a0.clone()
    if Kb.device.type != "cuda":
        raise ValueError("one_class_fista: unsupported device %s" % Kb.device)
    c = lambda t: t.contiguous()
    return fista_cuda(c(Kb), c(a0), c(u), c(s_target), c(al), c(be),
                      iters)[0]


# --------------------------------------------------------------------- #
def shift_from_extremes(lmin, lmax):
    """Per-graph (scale, dadd, L) from K's extremal eigenvalue estimates
    [S]: K's shift to PSD when lambda_min < -1e-6 (reference
    svm_theta.py:222-229) and the FISTA Lipschitz bound with 5 %
    headroom (Lanczos' lambda_max is a lower bound)."""
    cond = lmin < -_EIG_TOL
    one = torch.ones_like(lmin)
    scale = torch.where(cond, -1.0 / torch.where(cond, lmin, -one), one)
    dadd = torch.where(cond, one, torch.zeros_like(lmin))
    L = 1.05 * scale * torch.clamp(lmax, min=0.0) + dadd + 1e-3
    return scale, dadd, L


def tridiagonal_extremes(al, be):
    """The extremal eigenvalues (lambda_min, lambda_max) [S] of the [S,
    m, m] Lanczos tridiagonals: one batched ``eigvalsh``."""
    S, m = al.shape
    T = torch.diag_embed(al) + torch.diag_embed(be[:, :m - 1], 1) \
        + torch.diag_embed(be[:, :m - 1], -1)
    ev = torch.linalg.eigvalsh(T)
    return ev[:, 0], ev[:, -1]


def spectral_shift(al, be):
    """Per-graph (scale, dadd, L) from the Lanczos coefficients: the
    tridiagonal's extremal eigenvalues (:func:`tridiagonal_extremes`)
    through :func:`shift_from_extremes`; K11 computes the same inside."""
    return shift_from_extremes(*tridiagonal_extremes(al, be))


def _slab_cap(V):
    """Graphs a slab at padded size V (the JAX package's cap)."""
    return int(max(8, min(256, _SLAB_BYTES // (V * V * 4))))


def one_class_alphas(adjm, nu=0.5, fista_iters=_FISTA_ITERS, device=None):
    """Dual coefficients for every graph's one-class SVM, batched.

    ``adjm``: list of [n, n] adjacency matrices (any weights; binarized
    at ``> 1e-10`` with the diagonal dropped, matching the reference).
    Runs on ``device`` (default: the ambient device, else cuda).
    Returns a list of per-graph float64 alpha vectors in libsvm's
    scaling (0 <= a_i <= 1, sum = nu * n).

    A size bucket: K10 a slab on its densified K (the slab position
    seeds each graph's start vector, as in the JAX package), then the
    shift and FISTA over the whole bucket (:func:`one_class_fista`: one
    K11 launch on a card, on K's bit rows) and one fetch.
    """
    dev = resolve_device(device)
    out = [None] * len(adjm)
    buckets = {}
    for gi, A in enumerate(adjm):
        buckets.setdefault(_pow2(A.shape[0]), []).append(gi)
    for V, idxs in sorted(buckets.items()):
        B = len(idxs)
        flats = []
        u = np.zeros((B, V), np.float32)
        s_target = np.zeros(B, np.float32)
        for b, gi in enumerate(idxs):
            A = np.asarray(adjm[gi])
            n = A.shape[0]
            i, j = np.nonzero(A > _MIN_WEIGHT)
            keep = i != j
            flats.append(b * V * V + i[keep] * V + j[keep])
            u[b, :n] = 1.0
            s_target[b] = nu * n
        # libsvm's one-class initial point (svm.cpp solve_one_class): the
        # first floor(nu*n) alphas at the upper bound, the fractional
        # remainder next, zero elsewhere
        a0 = np.clip(s_target[:, None] - np.arange(V)[None, :],
                     0.0, 1.0).astype(np.float32) * u
        flat = np.concatenate(flats).astype(np.int64)
        tu, ta0, ts = (torch.from_numpy(x).to(dev)
                       for x in (u, a0, s_target))
        s_cap = _slab_cap(V)
        coeffs = []
        for s0 in range(0, B, s_cap):
            S = min(s_cap, B - s0)
            lo, hi = np.searchsorted(flat, [s0 * V * V, (s0 + S) * V * V])
            part = torch.from_numpy(flat[lo:hi] - s0 * V * V).to(dev)
            K = torch.zeros(S * V * V, dtype=torch.float32, device=dev)
            K.index_add_(0, part, torch.ones(part.numel(),
                                             dtype=torch.float32,
                                             device=dev))
            coeffs.append(lanczos(K.view(S, V, V),
                                  start_vector(tu[s0:s0 + S])))
        al = torch.cat([c[0] for c in coeffs])
        be = torch.cat([c[1] for c in coeffs])
        a = one_class_fista(adjacency_bits(flat, B, V, dev), ta0, tu, ts,
                            al, be, fista_iters)
        a = a.cpu().numpy().astype(np.float64)
        for b, gi in enumerate(idxs):
            out[gi] = a[b, :adjm[gi].shape[0]]
    return out
