"""Histogram-intersection Gram: K[i, j] = sum_l min(A[i, l], B[j, l]).

The counterpart of ``grakel_tpu/ops/intersect.py:min_intersection_gram``,
used by PyramidMatch's level Grams.  Two routes, chosen as the JAX
package chooses between its threshold GEMM and its Pallas kernel
(:func:`min_gram_route`):

* **count histograms** (every entry a nonnegative integer, none above
  ``_GEMM_MAX_T``) whose expanded width ``W' = sum_l T_l``,
  ``T_l = min(max_i A[i, l], max_j B[j, l])``, is at most
  ``_TC_MAX_RATIO_SYM`` (``B is A``) or ``_TC_MAX_RATIO_RECT`` times the
  width: the threshold-indicator identity
  ``sum_l min(a_l, b_l) = sum_l sum_{t <= T_l} [a_l >= t] [b_l >= t]``
  turns the Gram into one 0/1 product, computed on the tensor cores by
  the hand-written kernel K1-tc (``csrc/min_gram_tc.cu``) over int8
  indicators with s32 sums: exact;
* **everything else** (real values, large counts, expansions too wide to
  pay): the CUDA-core kernel K1 (``csrc/min_gram.cu``, the port of the
  Pallas kernel ``_min_gram_kernel``), accumulating in f32 as the Pallas
  kernel does: integer-valued histograms come out exact below 2^24.
  When B is A it computes the block upper triangle and mirrors it.

Both kernels return ``alpha * K`` or add it into ``out`` in their
epilogues.  ``route=`` names the kernel instead of routing: PyramidMatch
hands K1 its levels scaled by their integer weights and concatenated,
whose weighted maxima must not be routed again.

CPU tensors take each kernel's plain version: :func:`min_gram_plain`,
the pair-tiled broadcast-min-reduce of the JAX package's
``_min_gram_impl``, and the threshold expansion with an f64 product.

NeighborhoodHash's Gram adds two functions over R rounds of histograms
A [R, n, L]: :func:`min_intersection_gram_rounds` (the Pallas kernel's
second reach, ``_min_gram_rounds_impl``: one K1 call a round by default,
as the JAX function takes the Pallas kernel on every accelerator) and
:func:`jaccard_gram_rounds` (``_jaccard_rounds_impl``): the rounds'
Grams from :func:`min_intersection_gram_rounds`, each round routed,
then the Jaccard fold K5 (``csrc/jaccard.cu``, plain version
:func:`jaccard_fold_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["min_intersection_gram", "min_gram_route", "min_gram_plain",
           "min_gram_threshold_plain", "min_gram_cuda", "min_gram_tc_cuda",
           "k1_tile", "column_stats", "threshold_columns",
           "expand_thresholds", "min_intersection_gram_rounds",
           "jaccard_gram_rounds", "jaccard_fold_plain", "jaccard_fold_cuda",
           "K5_TILE"]

# counts above this take K1, as in grakel_tpu/ops/intersect.py
_GEMM_MAX_T = 2048
# K1-tc is taken while W' <= ratio * L, one ratio per call form.
# chip_smoke.py measures the break-even ratio at the labeled NCI1-scale
# levels: the W' / L at which K1-tc, its expansion included, costs as
# much device time as K1.  On an H100 80GB HBM3 at 700 W (PERF.md):
# symmetric 4110 x 4110 (fit_transform; both kernels compute the block
# triangle) 8.82 to 9.62; rectangular 411 x 3699 (transform of a 10-fold
# split; K1-tc expands A and B) 3.09 to 3.26.  Each limit is the floor
# of its smallest reading.  They are verified at these shapes only: a
# smaller transform batch expands B for fewer products and favours K1.
_TC_MAX_RATIO_SYM = 8.0
_TC_MAX_RATIO_RECT = 3.0
# K1-tc's rows are staged in 16-byte copies: W' pads to a multiple
_TC_K_ALIGN = 16


def min_gram_plain(A, B, tile=64):
    """Plain PyTorch K[i, j] = sum_l min(A[i, l], B[j, l]) over tiles of
    ``tile`` x ``tile`` pairs, so the [TI, TJ, L] intermediate stays
    bounded.  Works on any device; f32 [n, m]."""
    n, m = A.shape[0], B.shape[0]
    K = torch.empty((n, m), dtype=torch.float32, device=A.device)
    for i in range(0, n, tile):
        a = A[i:i + tile, None, :]
        for j in range(0, m, tile):
            K[i:i + tile, j:j + tile] = torch.minimum(
                a, B[None, j:j + tile, :]).sum(-1)
    return K


# --------------------------------------------------------------------- #
# routing and the threshold expansion
# --------------------------------------------------------------------- #

def min_gram_route(max_a, max_b, integer, symmetric):
    """The kernel that computes the Gram of A [n, L] and B [m, L] whose
    column maxima are ``max_a`` and ``max_b`` (length L), whose entries
    are all nonnegative integers when ``integer``, and where B is A when
    ``symmetric``: ``"min_gram_tc"`` (the threshold product on the
    tensor cores) when the inputs are counts no larger than
    ``_GEMM_MAX_T`` and ``W' = sum_l min(max_a[l], max_b[l])`` is at most
    ``_TC_MAX_RATIO_SYM * L`` (symmetric) or ``_TC_MAX_RATIO_RECT * L``;
    ``"min_gram"`` (K1 on the CUDA cores) otherwise."""
    if not integer:
        return "min_gram"
    max_a = np.asarray(max_a, np.float64)
    max_b = np.asarray(max_b, np.float64)
    if max_a.size and max(max_a.max(), max_b.max()) > _GEMM_MAX_T:
        return "min_gram"
    width = float(np.minimum(max_a, max_b).sum())
    ratio = _TC_MAX_RATIO_SYM if symmetric else _TC_MAX_RATIO_RECT
    return "min_gram_tc" if width <= ratio * max_a.size else "min_gram"


def _round_stats(A, B):
    """(column maxima of each round of A [R, L], of B [R, L], whether
    each round of both holds only nonnegative integers [R] bool) for
    nonempty f32 A [R, n, L] and B [R, m, L] on one device, in one
    device-to-host copy."""
    def part(X):
        bad = ((X < 0) | (X != torch.floor(X))).flatten(1).any(1)
        return torch.cat([X.amax(1), bad[:, None].to(X.dtype)], 1)
    L = A.shape[2]
    s = torch.cat([part(A), part(B)], 1).cpu().numpy()
    return (s[:, :L], s[:, L + 1:2 * L + 1],
            (s[:, L] == 0) & (s[:, 2 * L + 1] == 0))


def column_stats(A, B):
    """(column maxima of A, of B, whether every entry of both is a
    nonnegative integer) for nonempty A [n, L] and B [m, L] on one
    device: numpy arrays and a bool, in one device-to-host copy."""
    max_a, max_b, integer = _round_stats(A[None], B[None])
    return max_a[0], max_b[0], bool(integer[0])


def threshold_columns(T, align=_TC_K_ALIGN):
    """The expanded columns for per-column thresholds ``T`` (nonnegative
    integers, length L): int32 [2, W'p] of (source column, threshold)
    with ``E[:, w] = A[:, src[w]] >= thr[w]``, columns ``(l, t)`` for
    t = 1..T_l in l order, then zero columns (threshold 2^31 - 1) up to
    a multiple of ``align``."""
    T = np.asarray(T).astype(np.int64)
    width = int(T.sum())
    cols = np.zeros((2, -(-width // align) * align), np.int32)
    cols[1, width:] = np.iinfo(np.int32).max
    cols[0, :width] = np.repeat(np.arange(T.size), T)
    starts = np.cumsum(T) - T
    cols[1, :width] = np.arange(width) - np.repeat(starts, T) + 1
    return cols


def expand_thresholds(X, cols):
    """0/1 int8 [n, W'p] indicators ``X[:, cols[0]] >= cols[1]`` of f32
    X [n, L], with ``cols`` from :func:`threshold_columns` on X's
    device."""
    return (X.index_select(1, cols[0]) >= cols[1]).view(torch.int8)


def _indicator_product_plain(EA, EB):
    """Exact E_A E_B^T of 0/1 indicators as f32: an f64 product, exact
    while W' < 2^53."""
    return (EA.to(torch.float64) @ EB.to(torch.float64).T).to(torch.float32)


def min_gram_threshold_plain(A, B):
    """Plain PyTorch min-intersection Gram of nonnegative integer-valued
    A [n, L] and B [m, L] by the threshold expansion K1-tc computes
    (:func:`threshold_columns`, :func:`expand_thresholds`) and an exact
    f64 product.  Works on any device; f32 [n, m]."""
    A = A.to(torch.float32).contiguous()
    B = B.to(torch.float32).contiguous()
    if A.shape[0] == 0 or B.shape[0] == 0 or A.shape[1] == 0:
        return torch.zeros((A.shape[0], B.shape[0]), dtype=torch.float32,
                           device=A.device)
    max_a, max_b, integer = column_stats(A, B)
    if not integer:
        raise ValueError("min_gram_threshold_plain: inputs must be "
                         "nonnegative integers")
    cols = torch.from_numpy(threshold_columns(np.minimum(max_a, max_b)))
    cols = cols.to(A.device)
    return _indicator_product_plain(expand_thresholds(A, cols),
                                    expand_thresholds(B, cols))


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #

# K1's instantiations (csrc/min_gram.cu): id -> (block tile side, thread
# tile side); a block computes a side x side output tile
K1_TILES = {0: (64, 8), 1: (32, 4)}
# the 64-wide tile while its grid has at least 4 blocks a SM of an H100
# (132 SMs); below that the 32-wide one keeps the card fuller.  From the
# tile sweep of chip_smoke.py (PERF.md)
_K1_WIDE_MIN_BLOCKS = 4 * 132


def k1_tile(n, m, symmetric):
    """The K1 instantiation (a ``K1_TILES`` id) for an n x m Gram: 64 x 64
    blocks of 8 x 8 a thread when that grid has at least
    ``_K1_WIDE_MIN_BLOCKS`` blocks (the triangle's when ``symmetric``),
    else 32 x 32 blocks of 4 x 4 a thread."""
    tn, tm = -(-n // 64), -(-m // 64)
    blocks = tm * (tm + 1) // 2 if symmetric else tn * tm
    return 0 if blocks >= _K1_WIDE_MIN_BLOCKS else 1


def min_gram_cuda(A, B, out=None, alpha=1.0, tile=None):
    """Launch K1 (``csrc/min_gram.cu``): ``alpha * K`` with ``K[i, j] =
    sum_l min(A[i, l], B[j, l])`` as f32 [n, m], added into ``out`` (f32
    [n, m], contiguous) when given.  ``A`` [n, L] and ``B`` [m, L] are
    contiguous f32 CUDA tensors on one device; ``B is A`` computes the
    upper block triangle and mirrors it.  ``tile`` (a ``K1_TILES`` id)
    overrides :func:`k1_tile`, for measurements.  Returns the result
    tensor."""
    from .. import _build
    dev = A.device
    if dev.type != "cuda" or B.device != dev:
        raise ValueError("min_gram_cuda: A and B must be CUDA tensors on "
                         "one device")
    for X, name in ((A, "A"), (B, "B")):
        if X.dtype != torch.float32 or X.dim() != 2 \
                or not X.is_contiguous():
            raise ValueError("min_gram_cuda: %s must be a contiguous 2-D "
                             "float32 tensor" % name)
    n, L = A.shape
    m = B.shape[0]
    if B.shape[1] != L:
        raise ValueError("min_gram_cuda: A and B differ in width "
                         "(%d vs %d)" % (L, B.shape[1]))
    if max(n, m, L) >= 1 << 31:
        raise ValueError("min_gram_cuda: shape (%d, %d, %d) out of range"
                         % (n, m, L))
    sym = B is A
    if tile is None:
        tile = k1_tile(n, m, sym)
    elif tile not in K1_TILES:
        raise ValueError("min_gram_cuda: no tile %r (have %s)"
                         % (tile, sorted(K1_TILES)))
    if out is None:
        out, accumulate = torch.empty((n, m), dtype=torch.float32,
                                      device=dev), 0
    else:
        if out.shape != (n, m) or out.dtype != torch.float32 \
                or out.device != dev or not out.is_contiguous():
            raise ValueError("min_gram_cuda: out must be a contiguous f32 "
                             "[%d, %d] tensor on %s" % (n, m, dev))
        accumulate = 1
    if n == 0 or m == 0:
        return out
    _build.launch("grakel_min_gram", dev, A.data_ptr(), B.data_ptr(),
                  out.data_ptr(), n, m, L, float(alpha), accumulate,
                  int(sym), tile)
    min_gram_cuda.launches += 1
    return out


min_gram_cuda.launches = 0


def min_gram_tc_cuda(EA, EB, out=None, alpha=1.0):
    """Launch K1-tc (``csrc/min_gram_tc.cu``): ``alpha * EA @ EB.T`` as
    f32 [n, m], added into ``out`` (f32 [n, m], contiguous) when given.
    ``EA`` [n, k] and ``EB`` [m, k] are contiguous 0/1 int8 CUDA tensors
    on one device with k a multiple of 16; ``EB is EA`` computes the
    upper block triangle and mirrors it.  Returns the result tensor."""
    from .. import _build
    dev = EA.device
    if dev.type != "cuda" or EB.device != dev:
        raise ValueError("min_gram_tc_cuda: EA and EB must be CUDA tensors "
                         "on one device")
    for X, name in ((EA, "EA"), (EB, "EB")):
        if X.dtype != torch.int8 or X.dim() != 2 or not X.is_contiguous():
            raise ValueError("min_gram_tc_cuda: %s must be a contiguous 2-D "
                             "int8 tensor" % name)
    n, k = EA.shape
    m = EB.shape[0]
    if EB.shape[1] != k or k % _TC_K_ALIGN:
        raise ValueError("min_gram_tc_cuda: EA and EB need one width, a "
                         "multiple of %d (got %d and %d)"
                         % (_TC_K_ALIGN, k, EB.shape[1]))
    if max(n, m, k) >= 1 << 31 or (n + 127) // 128 > 65535:
        raise ValueError("min_gram_tc_cuda: shape (%d, %d, %d) out of range"
                         % (n, m, k))
    if out is None:
        out, accumulate = torch.empty((n, m), dtype=torch.float32,
                                      device=dev), 0
    else:
        if out.shape != (n, m) or out.dtype != torch.float32 \
                or out.device != dev or not out.is_contiguous():
            raise ValueError("min_gram_tc_cuda: out must be a contiguous "
                             "f32 [%d, %d] tensor on %s" % (n, m, dev))
        accumulate = 1
    if n == 0 or m == 0:
        return out
    _build.launch("grakel_min_gram_tc", dev, EA.data_ptr(), EB.data_ptr(),
                  out.data_ptr(), n, m, k, float(alpha), accumulate,
                  int(EB is EA))
    min_gram_tc_cuda.launches += 1
    return out


min_gram_tc_cuda.launches = 0


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #

def _fold(K, out, alpha):
    """alpha * K, added into ``out`` when given (the CPU routes; the
    kernels fold in their epilogues)."""
    if out is not None:
        return out.add_(K, alpha=alpha)
    return K if alpha == 1.0 else K.mul_(alpha)


def min_intersection_gram(A, B=None, tile=64, *, count_max=None,
                          out=None, alpha=1.0, route=None):
    """K[i, j] = sum_l min(A[i, l], B[j, l]); B defaults to A.

    A: [n, L], B: [m, L] tensors on one device, taken as f32.  Returns
    ``alpha * K`` as an f32 [n, m] tensor on that device, or adds it into
    ``out`` (f32 [n, m]) and returns ``out``.

    The route (:func:`min_gram_route`) needs the column maxima and
    whether every entry is a nonnegative integer; they are read from the
    device (:func:`column_stats`, one device-to-host copy) unless the
    caller passes ``count_max=(max_a, max_b)``, numpy column maxima of A
    and B.  That is a contract, not a hint: it says that A and B hold
    nonnegative integer counts with these column maxima (PyramidMatch's
    level matrices, built on the host), and it is not checked against
    the device data.  Inputs that break it give a wrong Gram.  ``route``
    (``"min_gram"`` or ``"min_gram_tc"``) names the kernel instead of
    routing; ``"min_gram"`` reads nothing, ``"min_gram_tc"`` needs counts
    as above.  CUDA tensors launch K1-tc or K1; CPU tensors take their
    plain versions."""
    sym = B is None or B is A
    B = A if B is None else B
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[1]:
        raise ValueError("min_intersection_gram: need [n, L] and [m, L]")
    if A.device != B.device:
        raise ValueError("min_intersection_gram: A and B on different "
                         "devices")
    if route not in (None, "min_gram", "min_gram_tc"):
        raise ValueError("min_intersection_gram: unknown route %r" % route)
    dev = A.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("min_intersection_gram: unsupported device %s"
                         % dev)
    A = A.to(torch.float32).contiguous()
    B = A if sym else B.to(torch.float32).contiguous()
    n, m = A.shape[0], B.shape[0]
    if n == 0 or m == 0:
        K = torch.zeros((n, m), dtype=torch.float32, device=dev)
        return _fold(K, out, alpha)
    if route != "min_gram":
        if count_max is None:
            max_a, max_b, integer = column_stats(A, B)
        else:
            max_a, max_b = (np.asarray(x, np.float64) for x in count_max)
            integer = True
            if max_a.shape != (A.shape[1],) \
                    or max_b.shape != (A.shape[1],) \
                    or (max_a < 0).any() or (max_b < 0).any() \
                    or (max_a != np.floor(max_a)).any() \
                    or (max_b != np.floor(max_b)).any():
                raise ValueError("min_intersection_gram: count_max must be "
                                 "two length-%d arrays of nonnegative "
                                 "integers" % A.shape[1])
        if route is None:
            route = min_gram_route(max_a, max_b, integer, sym)
        elif not integer:
            raise ValueError("min_intersection_gram: route min_gram_tc "
                             "needs nonnegative integer inputs")
    if route == "min_gram_tc":
        # from pageable memory a non-blocking copy is staged at once and
        # waits for nothing queued on the card
        cols = torch.from_numpy(threshold_columns(
            np.minimum(max_a, max_b))).to(dev, non_blocking=True)
        EA = expand_thresholds(A, cols)
        EB = EA if sym else expand_thresholds(B, cols)
        if dev.type == "cuda":
            return min_gram_tc_cuda(EA, EB, out, alpha)
        return _fold(_indicator_product_plain(EA, EB), out, alpha)
    if dev.type == "cuda":
        return min_gram_cuda(A, B, out, alpha)
    return _fold(min_gram_plain(A, B, tile), out, alpha)


# --------------------------------------------------------------------- #
# rounds: NeighborhoodHash's Gram
# --------------------------------------------------------------------- #

def _check_rounds(A, B, name):
    if A.dim() != 3 or B.dim() != 3 or A.shape[0] != B.shape[0] \
            or A.shape[2] != B.shape[2]:
        raise ValueError("%s: need A [R, n, L] and B [R, m, L]" % name)
    if A.device != B.device:
        raise ValueError("%s: A and B on different devices" % name)
    if A.device.type not in ("cuda", "cpu"):
        raise ValueError("%s: unsupported device %s" % (name, A.device))


def min_intersection_gram_rounds(A, B=None, *, route="min_gram",
                                 count_max=None):
    """Per-round min-intersection Grams: ``K[r, i, j] = sum_l min(A[r, i,
    l], B[r, j, l])`` for A [R, n, L] and B [R, m, L] (B defaults to A)
    on one device, as an f32 [R, n, m] tensor there.

    The counterpart of ``grakel_tpu/ops/intersect.py:
    min_intersection_gram_rounds``, which returns its PADDED device
    array for the caller to slice; this returns the unpadded stack.
    One :func:`min_intersection_gram` call a round, each adding into its
    slice of one zeroed stack through the kernels' ``out=`` epilogue.
    ``route="min_gram"`` (the default) takes K1 every round, as the JAX
    function takes the Pallas kernel on every accelerator; ``route=None``
    routes each round with :func:`min_gram_route` on its column maxima:
    ``count_max=(max_a, max_b)``, numpy [R, L] each, under
    :func:`min_intersection_gram`'s contract (nonnegative integer counts
    with these maxima, not checked), or else read with the integer check
    for all rounds in one device-to-host copy."""
    sym = B is None or B is A
    B = A if B is None else B
    _check_rounds(A, B, "min_intersection_gram_rounds")
    if route not in (None, "min_gram"):
        raise ValueError("min_intersection_gram_rounds: unknown route %r"
                         % route)
    A = A.to(torch.float32).contiguous()
    B = A if sym else B.to(torch.float32).contiguous()
    R, n, _ = A.shape
    m = B.shape[1]
    out = torch.zeros((R, n, m), dtype=torch.float32, device=A.device)
    if R == 0 or n == 0 or m == 0:
        return out
    kws = [{"route": "min_gram"}] * R
    if route is None:
        if count_max is None:
            max_a, max_b, integer = _round_stats(A, B)
        else:
            (max_a, max_b), integer = count_max, [True] * R
        kws = [{"count_max": (max_a[r], max_b[r])} if integer[r]
               else {"route": "min_gram"} for r in range(R)]
    for r in range(R):
        min_intersection_gram(A[r], None if sym else B[r], out=out[r],
                              **kws[r])
    return out


def jaccard_fold_plain(C, va, vb, symmetrize):
    """Plain PyTorch Jaccard fold: from per-round intersection counts C
    [R, n, m] and vertex counts va [n], vb [m] (f32, one device), f32
    ``K = mean_r where(d > 0, c_r / d, 0)``, ``d = va[i] + vb[j] -
    c_r``, and ``(K + K^T) / 2`` when ``symmetrize``, in the order
    XLA-CPU compiles ``_jaccard_rounds_impl``: rounds added in order from
    zero, the mean as a product with the f32 value of 1 / R.  Each step
    is one IEEE operation, so this equals the JAX function bit for bit,
    on any device."""
    R = C.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=C.device)
    acc = torch.zeros(C.shape[1:], dtype=torch.float32, device=C.device)
    for r in range(R):
        d = (va[:, None] + vb[None, :]) - C[r]
        acc = acc + torch.where(d > 0, C[r] / d, zero)
    acc = acc * torch.tensor(1.0 / R, dtype=torch.float32, device=C.device)
    if symmetrize:
        acc = (acc + acc.T) * 0.5
    return acc


_FOLD_ROUTES = {"rect": 0, "pair": 1, "triangle": 2}
# K5's tile side (csrc/jaccard.cu kTile): the triangle route reads the
# tiles (i // K5_TILE, j // K5_TILE) on or above the diagonal only
K5_TILE = 32


def jaccard_fold_cuda(C, va, vb, symmetrize, triangle=False):
    """Launch K5 (``csrc/jaccard.cu``): the fold of
    :func:`jaccard_fold_plain`, bit-identical to it.  ``C`` [R, n, m]
    (R >= 1), ``va`` [n] and ``vb`` [m] are contiguous f32 CUDA tensors
    on one device; ``symmetrize`` needs n == m.  Returns f32 K [n, m].

    Routes, one launch each (``route_launches`` counts them): "rect"
    without ``symmetrize``; "pair" (each (i, j), (j, i) folded together)
    with it; "triangle" with ``triangle`` too, the caller's promise that
    every C[r] is symmetric bit for bit and ``vb`` is ``va`` (the counts
    of one symmetric min-intersection call): it reads the upper triangle
    only, since then acc_ij == acc_ji and (x + x) * 0.5 == x exactly."""
    from .. import _build
    dev = C.device
    if not (dev.type == "cuda" and va.device == dev and vb.device == dev
            and C.dtype == va.dtype == vb.dtype == torch.float32
            and C.is_contiguous() and va.is_contiguous()
            and vb.is_contiguous() and C.dim() == 3 and va.dim() == 1
            and vb.dim() == 1 and C.shape[0] >= 1
            and va.shape[0] == C.shape[1] and vb.shape[0] == C.shape[2]
            and max(C.shape) < 1 << 31
            and C.shape[1] * C.shape[2] < 1 << 39
            and (not symmetrize or C.shape[1] == C.shape[2])
            and (not triangle or (symmetrize
                                  and vb.data_ptr() == va.data_ptr()))):
        raise ValueError("jaccard_fold_cuda: need contiguous f32 CUDA "
                         "tensors on one device: C [R >= 1, n, m], va [n], "
                         "vb [m]; n == m when symmetrizing; triangle only "
                         "symmetrizing with vb the same tensor as va")
    R, n, m = C.shape
    route = "triangle" if triangle else "pair" if symmetrize else "rect"
    K = torch.empty((n, m), dtype=torch.float32, device=dev)
    inv_r = float(torch.tensor(1.0 / R, dtype=torch.float32))
    _build.launch("grakel_jaccard_fold", dev, C.data_ptr(), va.data_ptr(),
                  vb.data_ptr(), K.data_ptr(), R, n, m, inv_r,
                  _FOLD_ROUTES[route])
    jaccard_fold_cuda.launches += 1
    jaccard_fold_cuda.route_launches[route] += 1
    return K


jaccard_fold_cuda.launches = 0
jaccard_fold_cuda.route_launches = dict.fromkeys(_FOLD_ROUTES, 0)


def jaccard_gram_rounds(A, B=None, va=None, vb=None, symmetrize=None):
    """Multiset-Jaccard Gram averaged over rounds (NeighborhoodHash's
    comparison; the counterpart of ``grakel_tpu/ops/intersect.py:
    jaccard_gram_rounds``):

    ``K[i, j] = mean_r c_r[i, j] / (va[i] + vb[j] - c_r[i, j])`` with
    ``c_r = sum_l min(A[r, i, l], B[r, j, l])`` and 0 where the
    denominator is not positive (two empty graphs).

    A [R, n, L] and B [R, m, L] (B defaults to A) are tensors of
    nonnegative integer counts on one device; va [n] and vb [m] vertex
    counts (default ones; vb defaults to va when B is A).  ``symmetrize``
    (default: B is A) returns ``(K + K^T) / 2`` and needs n == m.

    The column maxima of all rounds of both sides come to the host in
    one copy (which also checks the counts); the c_r come from one
    :func:`min_intersection_gram_rounds` call, each round routed by
    those maxima (K1-tc or K1); then one Jaccard fold: K5 for CUDA
    tensors (its triangle route when B is A and vb is va, or defaults
    to it), :func:`jaccard_fold_plain` for CPU tensors.
    Returns the unpadded f32 [n, m] (the JAX function returns a padded
    array for its caller to slice)."""
    same = B is None or B is A
    sym = same if symmetrize is None else bool(symmetrize)
    B = A if same else B
    _check_rounds(A, B, "jaccard_gram_rounds")
    dev = A.device
    A = A.to(torch.float32).contiguous()
    B = A if same else B.to(torch.float32).contiguous()
    R, n, _ = A.shape
    m = B.shape[1]
    if R == 0:
        raise ValueError("jaccard_gram_rounds: need at least one round")
    if sym and n != m:
        raise ValueError("jaccard_gram_rounds: symmetrizing needs n == m "
                         "(got %d and %d)" % (n, m))

    def counts(v, k):
        if v is None:
            return torch.ones(k, dtype=torch.float32, device=dev)
        return torch.as_tensor(v, device=dev).to(torch.float32).contiguous()

    va_t = counts(va, n)
    vb_t = va_t if (vb is va and va is not None) or (vb is None and same) \
        else counts(vb, m)
    if va_t.shape != (n,) or vb_t.shape != (m,):
        raise ValueError("jaccard_gram_rounds: va must be [%d] and vb [%d]"
                         % (n, m))
    if n == 0 or m == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=dev)
    max_a, max_b, integer = _round_stats(A, B)
    if not integer.all():
        raise ValueError("jaccard_gram_rounds: A and B must hold "
                         "nonnegative integer counts")
    C = min_intersection_gram_rounds(A, B, route=None,
                                     count_max=(max_a, max_b))
    if dev.type == "cuda":
        # one symmetric call's counts, one vertex-count tensor: K5 reads
        # the upper triangle only
        return jaccard_fold_cuda(C, va_t, vb_t, sym,
                                 triangle=sym and same and vb_t is va_t)
    return jaccard_fold_plain(C, va_t, vb_t, sym)
