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
  the hand-written kernel K1-tc (``csrc/min_gram_tc.cu``, wgmma fed by
  TMA) over int8 indicators with s32 sums: exact.  The indicators are
  written as int8 by a hand kernel beside it (:func:`expand_thresholds`,
  one launch for every round or level of a call); a column may carry an
  integer weight up to 127 as its value (``weights=``), so a weighted sum
  of Grams, PyramidMatch's levels, is one product;
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
as the JAX function takes the Pallas kernel on every accelerator; routed,
every round that takes K1-tc goes through ONE batched launch) and
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
           "k1_tile", "tc_tile", "TC_TILES", "column_stats",
           "threshold_columns", "expand_thresholds",
           "expand_thresholds_plain", "threshold_expand_cuda",
           "min_intersection_gram_rounds",
           "jaccard_gram_rounds", "jaccard_fold_plain", "jaccard_fold_cuda",
           "K5_TILE"]

# counts above this take K1, as in grakel_tpu/ops/intersect.py
_GEMM_MAX_T = 2048
# K1-tc is taken while W' <= ratio * L, one ratio per call form.
# chip_smoke.py measures the break-even ratio at the labeled NCI1-scale
# levels: the W' / L at which K1-tc, its expansion included, costs as
# much device time as K1.  On an H100 80GB HBM3 at 700 W (PERF.md), with
# the wgmma K1-tc and its expansion kernel: symmetric 4110 x 4110
# (fit_transform; both kernels compute the block triangle) 13.73 to
# 17.21; rectangular 411 x 3699 (transform of a 10-fold split; K1-tc
# expands A and B) 7.81 to 9.76 (the mma.sync design: 8.82 to 9.62 and 3.09 to
# 3.26).  Each limit is the floor of its smallest reading.  They are
# verified at these shapes only: a smaller transform batch expands B
# for fewer products and favours K1.
_TC_MAX_RATIO_SYM = 13.0
_TC_MAX_RATIO_RECT = 7.0
# K1-tc's rows are read by TMA, whose row strides are multiples of 16
# bytes: W' pads to a multiple
_TC_K_ALIGN = 16
# a column's weight is its int8 indicator value
_TC_MAX_WEIGHT = 127


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


def _check_weights(weights, L):
    """``weights`` as int64 numpy [L]: integers in 0.._TC_MAX_WEIGHT."""
    w = np.asarray(weights)
    if w.shape != (L,) or not np.all(w == np.floor(w)) \
            or (w.size and (w.min() < 0 or w.max() > _TC_MAX_WEIGHT)):
        raise ValueError("weights must be %d integers in 0..%d (an int8 "
                         "indicator value)" % (L, _TC_MAX_WEIGHT))
    return w.astype(np.int64)


def threshold_columns(T, weights=None, align=_TC_K_ALIGN):
    """The expanded columns for per-column thresholds ``T`` (nonnegative
    integers, length L): int32 [2, W'p] of (source column, threshold)
    with ``E[:, w] = A[:, src[w]] >= thr[w]``, columns ``(l, t)`` for
    t = 1..T_l in l order, then zero columns (source 0, threshold 2^31 -
    1) up to a multiple of ``align``.  ``weights`` (length L, integers
    0..127) adds a third row, each column's value ``weights[src[w]]``
    (0 on the padding).  T [R, L] (rounds) gives [R, 2 or 3, W'p], every
    round padded to the widest one's W'p."""
    T = np.asarray(T).astype(np.int64)
    if T.ndim == 2:
        parts = [threshold_columns(t, weights, align) for t in T]
        wp = max([p.shape[1] for p in parts], default=0)
        rows = 2 if weights is None else 3
        cols = np.zeros((len(parts), rows, wp), np.int32)
        cols[:, 1] = np.iinfo(np.int32).max
        for r, p in enumerate(parts):
            cols[r, :, :p.shape[1]] = p
        return cols
    width = int(T.sum())
    rows = 2 if weights is None else 3
    cols = np.zeros((rows, -(-width // align) * align), np.int32)
    cols[1, width:] = np.iinfo(np.int32).max
    cols[0, :width] = np.repeat(np.arange(T.size), T)
    starts = np.cumsum(T) - T
    cols[1, :width] = np.arange(width) - np.repeat(starts, T) + 1
    if weights is not None:
        cols[2, :width] = _check_weights(weights, T.size)[cols[0, :width]]
    return cols


def expand_thresholds_plain(X, cols, weighted=True, indicators=False):
    """Plain PyTorch threshold expansion: int8 ``E[..., i, w] = X[...,
    i, src_w] >= thr_w`` times the column's value (``cols``' third row
    when ``weighted`` and present, else 1), for f32 X [n, L] with cols
    [2 or 3, W'p], or X [R, n, L] with cols [R, 2 or 3, W'p] (one set a
    round), on X's device.  ``indicators`` returns (E, the 0/1
    indicators).  Works on any device."""
    batched = X.dim() == 3
    Xb, cb = (X, cols) if batched else (X[None], cols[None])
    R, n, _ = Xb.shape
    W = cb.shape[-1]
    src = cb[:, 0].long()[:, None, :].expand(R, n, W)
    hit = torch.gather(Xb, 2, src) >= cb[:, 1][:, None, :]
    E01 = hit.to(torch.int8)
    E = E01
    if weighted and cb.shape[1] == 3:
        E = torch.where(hit, cb[:, 2][:, None, :],
                        torch.zeros((), dtype=cb.dtype,
                                    device=cb.device)).to(torch.int8)
    if not batched:
        E, E01 = E[0], E01[0]
    return (E, E01) if indicators else E


def expand_thresholds(X, cols, weighted=True, indicators=False):
    """The int8 indicators of :func:`expand_thresholds_plain` (same
    arguments, ``cols`` from :func:`threshold_columns` on X's device):
    the expansion kernel (:func:`threshold_expand_cuda`, one launch) for
    CUDA tensors, the plain version for CPU tensors."""
    if X.device.type == "cuda":
        return threshold_expand_cuda(X, cols, weighted, indicators)
    return expand_thresholds_plain(X, cols, weighted, indicators)


def _indicator_product_plain(EA, EB):
    """Exact E_A E_B^T of int8 indicators (values to 127) as f32: an
    f64 product, exact while the sums stay below 2^53; [n, k] x [m, k]
    or batched [R, n, k] x [R, m, k]."""
    return torch.matmul(EA.to(torch.float64),
                        EB.to(torch.float64).transpose(-1, -2)).to(
                            torch.float32)


def min_gram_threshold_plain(A, B, weights=None):
    """Plain PyTorch min-intersection Gram of nonnegative integer-valued
    A [n, L] and B [m, L], or of each round of A [R, n, L] and B [R, m,
    L], by the threshold expansion K1-tc computes
    (:func:`threshold_columns`, :func:`expand_thresholds_plain`) and an
    exact f64 product; with ``weights`` (L integers 0..127) ``sum_l
    weights[l] min(A[i, l], B[j, l])``, the weights on A's indicators.
    Works on any device; f32 [n, m] or [R, n, m]."""
    batched = A.dim() == 3
    A = A.to(torch.float32).contiguous()
    B = B.to(torch.float32).contiguous()
    A3, B3 = (A, B) if batched else (A[None], B[None])
    R, n, L = A3.shape
    m = B3.shape[1]
    if n == 0 or m == 0 or L == 0 or R == 0:
        K = torch.zeros((R, n, m), dtype=torch.float32, device=A.device)
        return K if batched else K[0]
    max_a, max_b, integer = _round_stats(A3, B3)
    if not integer.all():
        raise ValueError("min_gram_threshold_plain: inputs must be "
                         "nonnegative integers")
    cols = torch.from_numpy(threshold_columns(np.minimum(max_a, max_b),
                                              weights)).to(A.device)
    K = _indicator_product_plain(
        expand_thresholds_plain(A3, cols),
        expand_thresholds_plain(B3, cols, weighted=False))
    return K if batched else K[0]


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


# K1-tc's instantiations (csrc/min_gram_tc.cu): id -> (tile rows BM,
# tile columns BN); BM / 64 consumer warpgroups, BN the wgmma width
TC_TILES = {0: (128, 128), 1: (64, 64), 2: (64, 128), 3: (128, 256)}
# a call's grid should have a block for at least half the SMs of an H100
# (132): a wider tile reads fewer operand bytes from L2 a product, and at
# NH's transform shape (3 x 64 x 4110) 99 blocks of 64 x 128 ran faster
# than 195 of 64 x 64 (chip_smoke.py's tile sweep, PERF.md)
_TC_FILL_BLOCKS = 66


def tc_tile(R, n, m, symmetric):
    """The K1-tc instantiation (a ``TC_TILES`` id) for R rounds of an n x
    m Gram: the first of 128 x 256, 128 x 128, 64 x 128, 64 x 64 (64-row
    tiles only when n <= 64) whose grid (R times the tiles that hold an
    entry on or above the diagonal when ``symmetric``, else the
    rectangle's) has at least ``_TC_FILL_BLOCKS`` blocks, else the
    smallest."""
    def blocks(t):
        bm, bn = TC_TILES[t]
        tn, tm = -(-n // bm), -(-m // bn)
        if symmetric:
            f = bn // bm
            return R * (f * tm * (tm + 1) // 2 - (f * tm - tn))
        return R * tn * tm
    order = [3, 0, 2, 1] if n > 64 else [2, 1]
    for t in order:
        if blocks(t) >= _TC_FILL_BLOCKS:
            return t
    return order[-1]


def min_gram_tc_cuda(EA, EB, out=None, alpha=1.0, symmetric=None,
                     tile=None):
    """Launch K1-tc (``csrc/min_gram_tc.cu``): ``alpha * EA @ EB^T`` as
    f32 [n, m], added into ``out`` when given, for int8 ``EA`` [n, k] and
    ``EB`` [m, k], or for each round of ``EA`` [R, n, k] and ``EB`` [R, m,
    k] into [R, n, m] in ONE launch.  Contiguous CUDA tensors on one
    device, k a multiple of 16, values up to 127 (s32 sums, f32 exact
    below 2^24).  ``symmetric`` (default: ``EB is EA``) is the caller's
    promise that each product is symmetric (EA may carry column weights
    of EB's indicators) and needs n == m: only the tiles that hold an
    entry on or above the diagonal are computed, and mirrored.  ``tile``
    (a ``TC_TILES`` id) overrides
    :func:`tc_tile`, for measurements.  Returns the result tensor."""
    from .. import _build
    dev = EA.device
    if dev.type != "cuda" or EB.device != dev:
        raise ValueError("min_gram_tc_cuda: EA and EB must be CUDA tensors "
                         "on one device")
    for X, name in ((EA, "EA"), (EB, "EB")):
        if X.dtype != torch.int8 or X.dim() not in (2, 3) \
                or X.dim() != EA.dim() or not X.is_contiguous() \
                or X.data_ptr() % 16:
            raise ValueError("min_gram_tc_cuda: %s must be a contiguous, "
                             "16-byte aligned 2-D or 3-D int8 tensor, as "
                             "the other" % name)
    batched = EA.dim() == 3
    R = EA.shape[0] if batched else 1
    n, k = EA.shape[-2:]
    m = EB.shape[-2]
    if EB.shape[-1] != k or k % _TC_K_ALIGN or (batched
                                                and EB.shape[0] != R):
        raise ValueError("min_gram_tc_cuda: EA and EB need one width, a "
                         "multiple of %d, and one round count (got %s and "
                         "%s)" % (_TC_K_ALIGN, tuple(EA.shape),
                                  tuple(EB.shape)))
    sym = EB is EA if symmetric is None else bool(symmetric)
    if sym and n != m:
        raise ValueError("min_gram_tc_cuda: a symmetric call needs n == m")
    if max(n, m, k, R) >= 1 << 31:
        raise ValueError("min_gram_tc_cuda: shape %s x %s out of range"
                         % (tuple(EA.shape), tuple(EB.shape)))
    if tile is None:
        tile = tc_tile(R, n, m, sym)
    elif tile not in TC_TILES:
        raise ValueError("min_gram_tc_cuda: no tile %r (have %s)"
                         % (tile, sorted(TC_TILES)))
    shape = (R, n, m) if batched else (n, m)
    if out is None:
        out, accumulate = torch.empty(shape, dtype=torch.float32,
                                      device=dev), 0
    else:
        if tuple(out.shape) != shape or out.dtype != torch.float32 \
                or out.device != dev or not out.is_contiguous():
            raise ValueError("min_gram_tc_cuda: out must be a contiguous "
                             "f32 %s tensor on %s" % (list(shape), dev))
        accumulate = 1
    if n == 0 or m == 0 or R == 0:
        return out
    _build.launch("grakel_min_gram_tc", dev, EA.data_ptr(), EB.data_ptr(),
                  out.data_ptr(), R, n, m, k, float(alpha), accumulate,
                  int(sym), tile)
    min_gram_tc_cuda.launches += 1
    return out


min_gram_tc_cuda.launches = 0


def min_gram_tc_mma_cuda(EA, EB):
    """Launch the earlier mma.sync design of K1-tc
    (``csrc/min_gram_tc_mma.cu``: one launch a 2-D product, the full
    square's tiles with those below the diagonal returning when ``EB is
    EA``): ``EA @ EB^T`` as f32 for 2-D arguments of
    :func:`min_gram_tc_cuda`.  Kept for measurement only
    (``chip_smoke.py`` times it beside K1-tc); no path calls it."""
    from .. import _build
    if EA.dim() != 2 or EB.dim() != 2 or EA.dtype != torch.int8 \
            or EB.dtype != torch.int8 or EA.device.type != "cuda" \
            or EB.device != EA.device or not EA.is_contiguous() \
            or not EB.is_contiguous() or EA.shape[1] != EB.shape[1] \
            or EA.shape[1] % _TC_K_ALIGN:
        raise ValueError("min_gram_tc_mma_cuda: need contiguous 2-D int8 "
                         "CUDA tensors of one width, a multiple of %d"
                         % _TC_K_ALIGN)
    n, k = EA.shape
    m = EB.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=EA.device)
    if n and m:
        _build.launch("grakel_min_gram_tc_mma", EA.device, EA.data_ptr(),
                      EB.data_ptr(), out.data_ptr(), n, m, k, 1.0, 0,
                      int(EB is EA))
        min_gram_tc_mma_cuda.launches += 1
    return out


min_gram_tc_mma_cuda.launches = 0


def threshold_expand_cuda(X, cols, weighted=True, indicators=False):
    """Launch the expansion kernel beside K1-tc (``csrc/min_gram_tc.cu``
    ``grakel_threshold_expand``): :func:`expand_thresholds_plain`'s int8
    indicators, equal bit for bit, for contiguous f32 X [n, L] with int32
    ``cols`` [2 or 3, W'p], or X [R, n, L] with cols [R, 2 or 3, W'p], on
    one CUDA device (W'p a multiple of 4; the values, ``cols``' third
    row, at most 127 as :func:`threshold_columns` writes them).  One
    launch writes E and, with ``indicators``, the 0/1 indicators beside
    it: returns (E, E01)."""
    from .. import _build
    dev = X.device
    if not (dev.type == "cuda" and cols.device == dev
            and X.dtype == torch.float32 and cols.dtype == torch.int32
            and X.is_contiguous() and cols.is_contiguous()
            and X.dim() in (2, 3) and cols.dim() == X.dim()
            and cols.shape[-2] in (2, 3) and cols.shape[-1] % 4 == 0
            and (X.dim() == 2 or cols.shape[0] == X.shape[0])
            and max(X.shape) < 1 << 31 and cols.shape[-1] < 1 << 31):
        raise ValueError("threshold_expand_cuda: need contiguous f32 X [n, "
                         "L] (or [R, n, L]) and int32 cols [2 or 3, W'p] "
                         "(or [R, 2 or 3, W'p]), W'p a multiple of 4, on "
                         "one CUDA device")
    batched = X.dim() == 3
    R = X.shape[0] if batched else 1
    n, L = X.shape[-2:]
    W = cols.shape[-1]
    use_val = int(weighted and cols.shape[-2] == 3)
    shape = (R, n, W) if batched else (n, W)
    E = torch.empty(shape, dtype=torch.int8, device=dev)
    E01 = torch.empty(shape, dtype=torch.int8, device=dev) \
        if indicators and use_val else None
    if n and W and R:
        _build.launch("grakel_threshold_expand", dev, X.data_ptr(),
                      cols.data_ptr(), E.data_ptr(),
                      0 if E01 is None else E01.data_ptr(), R, n, L, W,
                      cols.shape[-2], use_val)
        threshold_expand_cuda.launches += 1
    if indicators:
        return E, (E if E01 is None else E01)
    return E


threshold_expand_cuda.launches = 0


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #

def _fold(K, out, alpha):
    """alpha * K, added into ``out`` when given (the CPU routes; the
    kernels fold in their epilogues)."""
    if out is not None:
        return out.add_(K, alpha=alpha)
    return K if alpha == 1.0 else K.mul_(alpha)


def _threshold_gram(A, B, T, weights=None, out=None, alpha=1.0):
    """The threshold route for each round of A [R, n, L] and B [R, m, L]
    (None: B is A) on one device, thresholds T [R, L] (numpy): one
    expansion launch a side (one for both when B is A and weighted), then
    ONE K1-tc launch for all rounds on CUDA tensors, the exact f64
    product on CPU tensors.  ``weights`` (L integers 0..127) go on A's
    indicators.  Returns ``alpha * K`` [R, n, m], or adds it into
    ``out``."""
    sym = B is None
    cols = torch.from_numpy(threshold_columns(T, weights)).to(
        A.device, non_blocking=True)   # from pageable memory: staged at once
    if weights is None:
        EA = expand_thresholds(A, cols)
        EB = EA if sym else expand_thresholds(B, cols)
    elif sym:
        EA, EB = expand_thresholds(A, cols, indicators=True)
    else:
        EA = expand_thresholds(A, cols)
        EB = expand_thresholds(B, cols, weighted=False)
    if A.device.type == "cuda":
        return min_gram_tc_cuda(EA, EB, out, alpha, symmetric=sym)
    return _fold(_indicator_product_plain(EA, EB), out, alpha)


def min_intersection_gram(A, B=None, tile=64, *, count_max=None,
                          out=None, alpha=1.0, route=None, weights=None):
    """K[i, j] = sum_l min(A[i, l], B[j, l]); B defaults to A.

    A: [n, L], B: [m, L] tensors on one device, taken as f32.  Returns
    ``alpha * K`` as an f32 [n, m] tensor on that device, or adds it into
    ``out`` (f32 [n, m]) and returns ``out``.  ``weights`` (L integers
    0..127) weight the columns: ``K[i, j] = sum_l weights[l] min(A[i, l],
    B[j, l])``, on K1-tc as its indicators' values, on K1 as the columns
    scaled (w min(a, b) = min(w a, w b)).

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
    as above.  CUDA tensors launch K1-tc (after the expansion kernel) or
    K1; CPU tensors take their plain versions."""
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
    if weights is not None:
        weights = _check_weights(weights, A.shape[1])
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
        K = _threshold_gram(A[None], None if sym else B[None],
                            np.minimum(max_a, max_b)[None], weights,
                            None if out is None else out[None], alpha)
        return K[0] if out is None else out
    if weights is not None:
        w = torch.from_numpy(weights.astype(np.float32)).to(dev)
        A = A * w
        B = A if sym else B * w
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
    ``route="min_gram"`` (the default) takes K1 every round, as the JAX
    function takes the Pallas kernel on every accelerator: one K1 call a
    round, each adding into its slice of one zeroed stack through K1's
    ``out=`` epilogue.  ``route=None`` routes each round with
    :func:`min_gram_route` on its column maxima: ``count_max=(max_a,
    max_b)``, numpy [R, L] each, under :func:`min_intersection_gram`'s
    contract (nonnegative integer counts with these maxima, not checked),
    or else read with the integer check for all rounds in one
    device-to-host copy.  The rounds that take K1-tc go through one
    expansion launch a side and ONE K1-tc launch, which stores their
    Grams into the stack (every round's expansion padded to the widest
    round's W'); the rounds that take K1 stay K1 calls."""
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
    if R == 0 or n == 0 or m == 0:
        return torch.zeros((R, n, m), dtype=torch.float32, device=A.device)
    tc = []
    if route is None:
        if count_max is None:
            max_a, max_b, integer = _round_stats(A, B)
        else:
            (max_a, max_b), integer = count_max, [True] * R
        max_a, max_b = np.asarray(max_a), np.asarray(max_b)
        tc = [r for r in range(R) if integer[r] and min_gram_route(
            max_a[r], max_b[r], True, sym) == "min_gram_tc"]
    k1 = [r for r in range(R) if r not in tc]
    if not k1:
        T = np.minimum(max_a, max_b)
        return _threshold_gram(A, None if sym else B, T)
    out = torch.zeros((R, n, m), dtype=torch.float32, device=A.device)
    if tc:
        idx = torch.tensor(tc, device=A.device)
        At = A.index_select(0, idx)
        T = np.minimum(max_a[tc], max_b[tc])
        out[idx] = _threshold_gram(
            At, None if sym else B.index_select(0, idx), T)
    for r in k1:
        min_intersection_gram(A[r], None if sym else B[r], out=out[r],
                              route="min_gram")
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
