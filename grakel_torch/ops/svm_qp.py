"""Batched one-class SVM dual solve over a whole graph dataset.

The counterpart of ``grakel_tpu/ops/svm_qp.py``.  SvmTheta needs, per
graph, the dual coefficients of ``OneClassSVM(kernel="precomputed")`` on
the binarized adjacency: the solution of

    min_a  1/2 a^T K a   s.t.  0 <= a_i <= 1,  sum a = nu * n,

where K = (A > 1e-10) with zero diagonal, spectrally shifted to be PSD
(K <- K/(-lambda_min) + I when lambda_min < -1e-6).

Graphs bucket by padded size V (a power of two >= 8) and slabs of at
most ``s_cap`` graphs, as in the JAX package (a graph's slab position
seeds its Lanczos start vector, so the slabs are the same).  A slab runs:

* the densify: one ``index_add_`` of the slab's edges into a zeroed
  [S, V, V] f32 tensor on the device;
* K10 (``csrc/svm_qp.cu``, plain version :func:`lanczos_plain`): m = 64
  Lanczos steps without reorthogonalization, alpha and beta [S, m];
* the [S, m, m] tridiagonal's extremal eigenvalues, one batched
  ``torch.linalg.eigvalsh``, and the spectral shift (scale, dadd, the
  FISTA step 1/L);
* K11 (``csrc/svm_qp.cu``, plain version :func:`fista_plain`): 300
  FISTA iterations on the dual, each projected onto {0 <= a <= u,
  sum a = s} by 30 bisection steps on the simplex shift, warm-started
  at libsvm's own initial point a_i = clip(nu*n - i, 0, 1).

On a CUDA tensor :func:`lanczos` and :func:`one_class_fista` launch
their kernels (one launch a slab each) or raise; the plain versions
serve CPU tensors.  All f32, as the JAX program.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["one_class_alphas", "lanczos", "lanczos_plain", "lanczos_cuda",
           "one_class_fista", "fista_plain", "fista_cuda", "start_vector",
           "spectral_shift", "svm_route", "SVM_SMEM_BUDGET"]

_LANCZOS_M = 64
_FISTA_ITERS = 300
_BISECT_ITERS = 30
_MIN_WEIGHT = 1e-10
_EIG_TOL = 1e-6
_SLAB_BYTES = 1 << 30

# K10 and K11 hold a graph's K in shared memory while K and the
# kernels' vectors fit this budget (V <= 128); larger V reads K from
# device memory
SVM_SMEM_BUDGET = 200 * 1024


def _pow2(x):
    return max(8, 1 << (max(int(x) - 1, 1)).bit_length())


def svm_route(V):
    """K10's and K11's route for padded size ``V``: "shared" while the
    graph's K [V, V] f32 and six f32 vectors of V fit
    :data:`SVM_SMEM_BUDGET`, else "global"."""
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


def fista_cuda(K, a0, u, s_target, scale, dadd, L, iters=_FISTA_ITERS,
               bisect=_BISECT_ITERS, route=None):
    """Launch K11 (``csrc/svm_qp.cu``): :func:`fista_plain` on a card, a
    block a graph, every iteration and bisection step in one launch.
    Arguments as :func:`fista_plain`, contiguous f32 on one CUDA device;
    ``route`` as in :func:`lanczos_cuda`.  Returns a [S, V] f32."""
    from .. import _build
    dev = K.device
    S = K.shape[0] if K.dim() == 3 else -1
    V = K.shape[1] if K.dim() == 3 else 0
    if not (dev.type == "cuda" and _f32(K, dev, (S, V, V))
            and all(_f32(x, dev, (S, V)) for x in (a0, u))
            and all(_f32(x, dev, (S,)) for x in (s_target, scale, dadd, L))
            and 0 < V <= 8192 and iters >= 0 and bisect >= 0):
        raise ValueError("fista_cuda: need contiguous f32 K [S, V, V], a0 "
                         "and u [S, V], s_target, scale, dadd and L [S] on "
                         "one CUDA device (V <= 8192)")
    route = route or svm_route(V)
    out = torch.empty((S, V), dtype=torch.float32, device=dev)
    if S:
        _build.launch("grakel_svm_fista", dev, K.data_ptr(), a0.data_ptr(),
                      u.data_ptr(), s_target.data_ptr(), scale.data_ptr(),
                      dadd.data_ptr(), L.data_ptr(), out.data_ptr(), S, V,
                      int(iters), int(bisect), int(route == "shared"))
        fista_cuda.launches += 1
        fista_cuda.route_launches[route] += 1
    return out


fista_cuda.launches = 0
fista_cuda.route_launches = {"shared": 0, "global": 0}


def one_class_fista(K, a0, u, s_target, scale, dadd, L,
                    iters=_FISTA_ITERS):
    """:func:`fista_plain` for CPU tensors, K11 for CUDA ones."""
    if K.device.type == "cpu":
        return fista_plain(K, a0, u, s_target, scale, dadd, L, iters)
    if K.device.type != "cuda":
        raise ValueError("one_class_fista: unsupported device %s" % K.device)
    c = lambda t: t.contiguous()
    return fista_cuda(c(K), c(a0), c(u), c(s_target), c(scale), c(dadd),
                      c(L), iters)


# --------------------------------------------------------------------- #
def spectral_shift(al, be):
    """Per-graph (scale, dadd, L) from the Lanczos coefficients: the
    extremal eigenvalues of the [S, m, m] tridiagonal (one batched
    ``eigvalsh``), K's shift to PSD when lambda_min < -1e-6 (reference
    svm_theta.py:222-229) and the FISTA Lipschitz bound with 5 %
    headroom (Lanczos' lambda_max is a lower bound)."""
    S, m = al.shape
    T = torch.diag_embed(al) + torch.diag_embed(be[:, :m - 1], 1) \
        + torch.diag_embed(be[:, :m - 1], -1)
    ev = torch.linalg.eigvalsh(T)
    lmin, lmax = ev[:, 0], ev[:, -1]
    cond = lmin < -_EIG_TOL
    one = torch.ones_like(lmin)
    scale = torch.where(cond, -1.0 / torch.where(cond, lmin, -one), one)
    dadd = torch.where(cond, one, torch.zeros_like(lmin))
    L = 1.05 * scale * torch.clamp(lmax, min=0.0) + dadd + 1e-3
    return scale, dadd, L


def one_class_alphas(adjm, nu=0.5, fista_iters=_FISTA_ITERS, device=None):
    """Dual coefficients for every graph's one-class SVM, batched.

    ``adjm``: list of [n, n] adjacency matrices (any weights; binarized
    at ``> 1e-10`` with the diagonal dropped, matching the reference).
    Runs on ``device`` (default: the ambient device, else cuda).
    Returns a list of per-graph float64 alpha vectors in libsvm's
    scaling (0 <= a_i <= 1, sum = nu * n).
    """
    dev = resolve_device(device)
    out = [None] * len(adjm)
    buckets = {}
    for gi, A in enumerate(adjm):
        buckets.setdefault(_pow2(A.shape[0]), []).append(gi)
    for V, idxs in sorted(buckets.items()):
        s_cap = int(max(8, min(256, _SLAB_BYTES // (V * V * 4))))
        for s0 in range(0, len(idxs), s_cap):
            slab = idxs[s0:s0 + s_cap]
            S = len(slab)
            flats = []
            u = np.zeros((S, V), np.float32)
            s_target = np.zeros(S, np.float32)
            for g, gi in enumerate(slab):
                A = np.asarray(adjm[gi])
                n = A.shape[0]
                i, j = np.nonzero(A > _MIN_WEIGHT)
                keep = i != j
                flats.append(g * V * V + i[keep] * V + j[keep])
                u[g, :n] = 1.0
                s_target[g] = nu * n
            # libsvm's one-class initial point (svm.cpp solve_one_class):
            # the first floor(nu*n) alphas at the upper bound, the
            # fractional remainder next, zero elsewhere
            a0 = np.clip(s_target[:, None] - np.arange(V)[None, :],
                         0.0, 1.0).astype(np.float32) * u
            flat = torch.from_numpy(np.concatenate(flats).astype(np.int64))
            K = torch.zeros(S * V * V, dtype=torch.float32, device=dev)
            K.index_add_(0, flat.to(dev), torch.ones(
                flat.numel(), dtype=torch.float32, device=dev))
            K = K.view(S, V, V)
            tu, ta0, ts = (torch.from_numpy(x).to(dev)
                           for x in (u, a0, s_target))
            al, be = lanczos(K, start_vector(tu))
            scale, dadd, L = spectral_shift(al, be)
            a = one_class_fista(K, ta0, tu, ts, scale, dadd, L, fista_iters)
            a = a.cpu().numpy().astype(np.float64)
            for g, gi in enumerate(slab):
                out[gi] = a[g, :adjm[gi].shape[0]]
    return out
