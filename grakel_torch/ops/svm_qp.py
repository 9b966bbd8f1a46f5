"""Batched one-class SVM dual solve over a whole graph dataset.

The counterpart of ``grakel_tpu/ops/svm_qp.py``.  SvmTheta needs, per
graph, the dual coefficients of ``OneClassSVM(kernel="precomputed")`` on
the binarized adjacency: the solution of

    min_a  1/2 a^T K a   s.t.  0 <= a_i <= 1,  sum a = nu * n,

where K = (A > 1e-10) with zero diagonal, spectrally shifted to be PSD
(K <- K/(-lambda_min) + I when lambda_min < -1e-6).

Graphs bucket by padded size V (a power of two >= 8), as in the JAX
package, whose slabs of at most ``s_cap`` graphs a bucket seed each
graph's Lanczos start vector by its position in its slab
(:func:`bucket_start_vector`).  A bucket runs:

* K's rows as bit masks (:func:`adjacency_bits`, one ``index_add_``);
* on a card ONE launch of ``csrc/svm_qp.cu`` (:func:`solve_cuda`) for
  the whole bucket: K10, m = 64 Lanczos steps without
  reorthogonalization (alpha and beta [S, m]), then K11, each graph's
  extremal eigenvalues of its [m, m] tridiagonal by Sturm counts, the
  spectral shift (scale, dadd, the FISTA step 1/L) from them, and 300
  FISTA iterations on the dual, each projected onto {0 <= a <= u, sum a
  = s} by 30 bisection steps on the simplex shift, warm-started at
  libsvm's own initial point a_i = clip(nu*n - i, 0, 1); a warp a graph
  up to V = 64, a block a graph past it, on the bit rows (no dense K on
  the card);
* one fetch of the bucket's alphas.

The plain version (:func:`one_class_solve_plain`; the CPU route) is
:func:`lanczos_plain` a slab at a time on the dense K of the bit rows
(:func:`dense_from_bits`), then :func:`spectral_shift` (one batched
``torch.linalg.eigvalsh``) and :func:`fista_plain`, a slab at a time
(:func:`one_class_fista_plain`).  On a CUDA tensor the wrappers launch the
kernel or raise.  All f32, as the JAX program (the eigenvalue search in
f64, to the f32 rounding).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["one_class_alphas", "one_class_solve", "one_class_solve_plain",
           "solve_cuda", "lanczos_plain", "lanczos_bits_plain",
           "lanczos_cuda", "one_class_fista_plain", "fista_plain", "fista_cuda",
           "start_vector", "bucket_start_vector", "spectral_shift",
           "shift_from_extremes", "tridiagonal_extremes", "adjacency_bits",
           "dense_from_bits", "fista_momenta", "solve_route", "WARP_MAX_V"]

_LANCZOS_M = 64
_FISTA_ITERS = 300
_BISECT_ITERS = 30
_MIN_WEIGHT = 1e-10
_EIG_TOL = 1e-6
_SLAB_BYTES = 1 << 30

# the kernels run a warp a graph up to this padded size, a block a graph
# past it
WARP_MAX_V = 64


def _pow2(x):
    return max(8, 1 << (max(int(x) - 1, 1)).bit_length())


def _slab_cap(V):
    """Graphs a slab at padded size V (the JAX package's cap)."""
    return int(max(8, min(256, _SLAB_BYTES // (V * V * 4))))


def _slabs(B, V):
    """The slices of a bucket of B graphs at padded size V into slabs of
    at most :func:`_slab_cap` graphs."""
    cap = _slab_cap(V)
    return [slice(s0, min(s0 + cap, B)) for s0 in range(0, B, cap)]


def start_vector(u):
    """The Lanczos start vector before normalization, cos(1.372954 i +
    0.718281 g) u for vertex i of the slab's graph g (the JAX program's,
    in f32)."""
    S, V = u.shape
    i_v = torch.arange(V, dtype=torch.float32, device=u.device)[None, :]
    g_v = torch.arange(S, dtype=torch.float32, device=u.device)[:, None]
    return torch.cos(1.372954 * i_v + 0.718281 * g_v) * u


def bucket_start_vector(u):
    """The start vectors of a whole bucket, u [B, V]: :func:`start_vector`
    a slab at a time, concatenated, so each graph's is seeded by its
    position within its slab (g = b mod s_cap)."""
    B, V = u.shape
    return torch.cat([start_vector(u[sl]) for sl in _slabs(B, V)])


def solve_route(V):
    """The kernels' route for padded size ``V``: "warp" (a warp a graph,
    K's rows as bit masks in registers) up to :data:`WARP_MAX_V`, "block"
    (a block a graph) past it."""
    return "warp" if V <= WARP_MAX_V else "block"


# --------------------------------------------------------------------- #
# the plain versions
# --------------------------------------------------------------------- #

def lanczos_plain(K, v0, m=_LANCZOS_M):
    """``m`` Lanczos steps of K [S, V, V] f32 from the start vectors v0
    [S, V] (normalized here; a zero row stays zero), no
    reorthogonalization: returns alpha, beta [S, m] f32 (beta_j = 0 where
    the step's residual norm is at most 1e-6, and the next vector is
    then zero).  K10's plain version."""
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


def one_class_fista_plain(Kb, a0, u, s_target, al, be,
                          iters=_FISTA_ITERS):
    """K11's plain version over a bucket: :func:`spectral_shift` and
    :func:`fista_plain` on the dense K of the bit rows ``Kb``, a slab of
    graphs at a time (the solve is per graph; a slab bounds the dense
    K's memory).  Returns a [S, V]."""
    S, V, _ = Kb.shape
    out = [fista_plain(dense_from_bits(Kb[sl], V), a0[sl], u[sl],
                       s_target[sl], *spectral_shift(al[sl], be[sl]), iters)
           for sl in _slabs(S, V)]
    return torch.cat(out) if out else a0.clone()


def lanczos_bits_plain(Kb, v0, m=_LANCZOS_M):
    """K10's plain version over a bucket: :func:`lanczos_plain` a slab at
    a time on the dense K of the bit rows ``Kb`` [S, V, ceil(V / 32)],
    from the start vectors v0 [S, V] (:func:`bucket_start_vector`).
    Returns alpha, beta [S, m]."""
    S, V, _ = Kb.shape
    al, be = zip(*(lanczos_plain(dense_from_bits(Kb[sl], V), v0[sl], m)
                   for sl in _slabs(S, V)))
    return torch.cat(al), torch.cat(be)


def one_class_solve_plain(Kb, v0, a0, u, s_target, iters=_FISTA_ITERS,
                          m=_LANCZOS_M):
    """The plain version of a bucket's solve (:func:`solve_cuda`), on any
    device: :func:`lanczos_bits_plain`, then
    :func:`one_class_fista_plain`.  Returns (a [S, V], al, be [S, m])."""
    al, be = lanczos_bits_plain(Kb, v0, m)
    return one_class_fista_plain(Kb, a0, u, s_target, al, be, iters), al, be


# --------------------------------------------------------------------- #
# K10 and K11: one launch a size bucket
# --------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _momenta_on(iters, device):
    return torch.from_numpy(fista_momenta(iters)).to(device)


def _f32(t, dev, shape):
    return (t is not None and t.device == dev and t.dtype == torch.float32
            and tuple(t.shape) == shape and t.is_contiguous())


def _launch(Kb, v0, a0, u, s_target, al, be, m, iters, bisect, route,
            lanczos, name):
    """Check the inputs of ``grakel_svm_solve`` and launch it once.
    ``lanczos``: K10 runs from v0 and writes al, be (else it reads them);
    K11 runs unless ``lanczos`` and iters = 0.  Returns (a, lam) from
    K11, or (None, None) when it did not run."""
    from .. import _build
    dev = Kb.device
    S = Kb.shape[0] if Kb.dim() == 3 else -1
    V = Kb.shape[1] if Kb.dim() == 3 else 0
    fista = not lanczos or iters > 0
    route = route or solve_route(V)
    if not (dev.type == "cuda" and Kb.dtype == torch.int32
            and Kb.is_contiguous() and Kb.dim() == 3
            and Kb.shape[2] == (V + 31) // 32
            and 8 <= V <= 8192 and V & (V - 1) == 0 and m > 0
            and (not lanczos or _f32(v0, dev, (S, V)))
            and all(_f32(x, dev, (S, m)) for x in (al, be))
            and (not fista or (all(_f32(x, dev, (S, V)) for x in (a0, u))
                               and _f32(s_target, dev, (S,))))
            and iters >= 0 and bisect >= 0
            and route in ("warp", "block")
            and (route == "block" or V <= WARP_MAX_V)):
        raise ValueError(
            "%s: need contiguous int32 bit rows Kb [S, V, ceil(V / 32)] and "
            "f32 %s on one CUDA device (V a power of two, 8 <= V <= 8192; "
            "route warp only up to V = %d)"
            % (name, ", ".join(
                (["v0 [S, V]"] if lanczos else ["al and be [S, m]"])
                + (["a0 and u [S, V], s_target [S]"] if fista else [])),
               WARP_MAX_V))
    out = lam = None
    if fista:
        out = torch.empty((S, V), dtype=torch.float32, device=dev)
        lam = torch.empty((S, 2), dtype=torch.float32, device=dev)
    if S:
        p = lambda t: None if t is None else t.data_ptr()
        coef = _momenta_on(int(iters), dev) if fista else None
        _build.launch("grakel_svm_solve", dev, Kb.data_ptr(), p(v0), p(a0),
                      p(u), p(s_target), al.data_ptr(), be.data_ptr(),
                      p(coef), p(out), p(lam), S, V, m, int(iters),
                      int(bisect), int(route == "warp"), int(lanczos))
        for kernel, ran in ((lanczos_cuda, lanczos), (fista_cuda, fista),
                            (solve_cuda, lanczos and fista)):
            if ran:
                kernel.launches += 1
                kernel.route_launches[route] += 1
    return out, lam


def solve_cuda(Kb, v0, a0, u, s_target, m=_LANCZOS_M, iters=_FISTA_ITERS,
               bisect=_BISECT_ITERS, route=None):
    """K10 and K11 (``csrc/svm_qp.cu``) of a size bucket in one launch:
    :func:`one_class_solve_plain` on a card.  Kb [S, V, ceil(V / 32)]
    int32, K's bit rows (:func:`adjacency_bits`); v0 [S, V]
    (:func:`bucket_start_vector`), a0, u [S, V] and s_target [S],
    contiguous f32 on one CUDA device.  Each graph's warp (a block past V
    = 64) runs ``m`` Lanczos steps on the bit rows, finds its
    tridiagonal's extremal eigenvalues by Sturm-count multisection (f64,
    to the f32 rounding), takes :func:`spectral_shift`'s scale, dadd and
    L from them, and runs ``iters`` FISTA steps of ``bisect`` bisection
    steps each; ``route`` ("warp" / "block", default :func:`solve_route`)
    overrides the route for measurements.  Returns (a [S, V], lam [S, 2],
    al [S, m], be [S, m]) f32: the alphas, lambda_min and lambda_max, and
    the Lanczos coefficients.  Counts on ``solve_cuda.launches`` and, as
    the launch runs both kernels, on :func:`lanczos_cuda`'s and
    :func:`fista_cuda`'s."""
    dev = Kb.device
    S = Kb.shape[0] if Kb.dim() == 3 else 0
    al = torch.empty((S, m), dtype=torch.float32, device=dev)
    be = torch.empty((S, m), dtype=torch.float32, device=dev)
    a, lam = _launch(Kb, v0, a0, u, s_target, al, be, m, iters, bisect,
                     route, True, "solve_cuda")
    return a, lam, al, be


def lanczos_cuda(Kb, v0, m=_LANCZOS_M, route=None):
    """K10 alone: the launch of :func:`solve_cuda` with iters = 0, which
    stops after the Lanczos loop; :func:`lanczos_plain` on the dense K of
    the bit rows ``Kb`` on a card.  Kb [S, V, ceil(V / 32)] int32, v0 [S,
    V] contiguous f32 on one CUDA device.  Returns alpha, beta [S, m] f32.
    ``lanczos_cuda.launches`` counts every launch that ran K10, fused or
    alone."""
    dev = Kb.device
    S = Kb.shape[0] if Kb.dim() == 3 else 0
    al = torch.empty((S, m), dtype=torch.float32, device=dev)
    be = torch.empty((S, m), dtype=torch.float32, device=dev)
    _launch(Kb, v0, None, None, None, al, be, m, 0, _BISECT_ITERS, route,
            True, "lanczos_cuda")
    return al, be


def fista_cuda(Kb, a0, u, s_target, al, be, iters=_FISTA_ITERS,
               bisect=_BISECT_ITERS, route=None):
    """K11 alone: the launch of :func:`solve_cuda` with K10 off, reading
    the Lanczos coefficients al, be [S, m] (contiguous f32, with a0, u
    [S, V] and s_target [S]); :func:`spectral_shift` and
    :func:`fista_plain` on a card.  Returns (a [S, V], lam [S, 2]) f32:
    the alphas, and lambda_min and lambda_max.  ``fista_cuda.launches``
    counts every launch that ran K11, fused or alone."""
    m = al.shape[1] if al.dim() == 2 else 0
    return _launch(Kb, None, a0, u, s_target, al, be, m, iters, bisect,
                   route, False, "fista_cuda")


for _k in (solve_cuda, lanczos_cuda, fista_cuda):
    _k.launches = 0
    _k.route_launches = {"warp": 0, "block": 0}


def one_class_solve(Kb, v0, a0, u, s_target, iters=_FISTA_ITERS):
    """A size bucket's one-class solve, the alphas [S, V]: one
    :func:`solve_cuda` launch for CUDA tensors, :func:`one_class_solve_plain`
    for CPU ones."""
    if Kb.device.type == "cpu":
        return one_class_solve_plain(Kb, v0, a0, u, s_target, iters)[0]
    if Kb.device.type != "cuda":
        raise ValueError("one_class_solve: unsupported device %s"
                         % Kb.device)
    c = lambda t: t.contiguous()
    return solve_cuda(c(Kb), c(v0), c(a0), c(u), c(s_target),
                      iters=iters)[0]


def one_class_alphas(adjm, nu=0.5, fista_iters=_FISTA_ITERS, device=None):
    """Dual coefficients for every graph's one-class SVM, batched.

    ``adjm``: list of [n, n] adjacency matrices (any weights; binarized
    at ``> 1e-10`` with the diagonal dropped, matching the reference).
    Runs on ``device`` (default: the ambient device, else cuda).
    Returns a list of per-graph float64 alpha vectors in libsvm's
    scaling (0 <= a_i <= 1, sum = nu * n).

    A size bucket: K's bit rows, the start vectors seeded by each graph's
    slab position (as in the JAX package), :func:`one_class_solve` (one
    launch of K10 and K11 on a card) and one fetch.
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
        a = one_class_solve(adjacency_bits(flat, B, V, dev),
                            bucket_start_vector(tu), ta0, tu, ts, fista_iters)
        a = a.cpu().numpy().astype(np.float64)
        for b, gi in enumerate(idxs):
            out[gi] = a[b, :adjm[gi].shape[0]]
    return out
