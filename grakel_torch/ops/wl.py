"""Weisfeiler-Lehman label refinement on tensors.

The counterpart of ``grakel_tpu/ops/wl.py``.  One refinement step:

1. hash each node's (own label, neighbour-label multiset) with a pair of
   independent 32-bit commutative multiset hashes (sums of mixed
   neighbour labels wrap mod 2^32, so the hash is order-free and matches
   the reference's sorted-credential semantics): :func:`wl_hash_refine`,
   the hand-written CUDA kernel K2 for CUDA tensors and its plain int64
   version for CPU tensors;
2. compact hash pairs to dense ids ranked by (h1, h2) as unsigned
   values, with occurrence counts: :func:`compact_ids`, one
   ``torch.unique`` on the tensors' device.

Grams are label-permutation invariant, so ids ranked by hash value give
the reference's Grams.  Two distinct credentials colliding in BOTH
32-bit hashes has probability ~2^-64 per pair.
"""

from __future__ import annotations

import torch

__all__ = ["wl_hash_refine", "compact_ids", "split_singletons"]

_M32 = 0xFFFFFFFF
_SEED_E1, _SEED_E2 = 0x9E3779B9, 0x7F4A7C15
_MUL1, _MUL2 = 0x9E3779B9, 0x85EBCA6B
_FIN1, _FIN2 = 0x165667B1, 0x27D4EB2F


# --------------------------------------------------------------------- #
# plain version (CPU tensors; the reference the kernel is held against)
# --------------------------------------------------------------------- #

def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow:
    split x into 16-bit halves so each partial product stays < 2^48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x, seed):
    """murmur3 32-bit finalizer with a seed fold, on int64 holding u32."""
    x = x ^ seed
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def wl_hash_refine_plain(labels, senders, receivers, edge_valid):
    """Plain PyTorch WL hash step, in int64 masked to 32 bits (PyTorch's
    uint32 lacks ``>>``, ``+`` and ``index_add_`` on the CPU).  Returns
    (h1, h2) int32 tensors holding the u32 bit patterns."""
    l = labels.to(torch.int64) & _M32
    nl = l[receivers.to(torch.int64)]
    ev = edge_valid.to(torch.bool)
    zero = torch.zeros((), dtype=torch.int64, device=l.device)
    m1 = torch.where(ev, _fmix32(nl, _SEED_E1), zero)
    m2 = torch.where(ev, _fmix32(nl, _SEED_E2), zero)
    n = l.shape[0]
    s = senders.to(torch.int64)
    sum1 = torch.zeros(n, dtype=torch.int64, device=l.device)
    sum2 = torch.zeros(n, dtype=torch.int64, device=l.device)
    sum1.index_add_(0, s, m1)
    sum2.index_add_(0, s, m2)
    h1 = _fmix32((_mul32(l, _MUL1) + sum1) & _M32, _FIN1)
    h2 = _fmix32((_mul32(l, _MUL2) + sum2) & _M32, _FIN2)
    return _as_i32(h1), _as_i32(h2)


def _as_i32(u):
    """int64 holding u32 values -> int32 with the same bit pattern."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


# --------------------------------------------------------------------- #
# K2 wrapper
# --------------------------------------------------------------------- #

def wl_hash_refine_cuda(labels, senders, receivers, edge_valid):
    """Launch K2 (``csrc/wl_hash.cu``).  Every argument must be a
    contiguous CUDA tensor on one device: labels int32 [N], senders and
    receivers int32 [E] in [0, N), edge_valid bool [E].  Returns (h1, h2)
    int32 [N]."""
    from .. import _build
    args = (labels, senders, receivers, edge_valid)
    dev = labels.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("wl_hash_refine_cuda: all inputs must be CUDA "
                         "tensors on one device")
    for a, dt, name in ((labels, torch.int32, "labels"),
                        (senders, torch.int32, "senders"),
                        (receivers, torch.int32, "receivers"),
                        (edge_valid, torch.bool, "edge_valid")):
        if a.dtype != dt or a.dim() != 1 or not a.is_contiguous():
            raise ValueError("wl_hash_refine_cuda: %s must be a contiguous "
                             "1-D %s tensor" % (name, dt))
    n, e = labels.shape[0], senders.shape[0]
    if receivers.shape[0] != e or edge_valid.shape[0] != e:
        raise ValueError("wl_hash_refine_cuda: edge arrays differ in length")
    if n >= 1 << 31 or e >= 1 << 31:
        raise ValueError("wl_hash_refine_cuda: sizes must fit in int32")
    if e:  # the kernel indexes with them: an out-of-range id faults
        lo, hi = torch.aminmax(torch.stack([senders, receivers]))
        if int(lo) < 0 or int(hi) >= n:
            raise ValueError("wl_hash_refine_cuda: edge endpoints outside "
                             "[0, %d)" % n)
    lib = _build.load_library()
    sums = torch.zeros((2, n), dtype=torch.int32, device=dev)  # u32 scratch
    h = torch.empty((2, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.grakel_wl_hash_refine(
            labels.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
            edge_valid.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            h[0].data_ptr(), h[1].data_ptr(), n, e, stream)
    _build.check(err, "grakel_wl_hash_refine")
    wl_hash_refine_cuda.launches += 1
    return h[0], h[1]


wl_hash_refine_cuda.launches = 0


def wl_hash_refine(labels, senders, receivers, edge_valid):
    """One WL refinement returning the raw (h1, h2) hash pairs as int32
    bit patterns, without id compaction.  Each node aggregates the labels
    of its OUT-neighbours (edge u->v contributes l(v) to u).

    CUDA tensors launch K2; CPU tensors take the plain version."""
    dev = labels.device
    if dev.type == "cuda":
        return wl_hash_refine_cuda(
            labels.to(torch.int32).contiguous(),
            senders.to(torch.int32).contiguous(),
            receivers.to(torch.int32).contiguous(),
            edge_valid.to(torch.bool).contiguous())
    if dev.type == "cpu":
        return wl_hash_refine_plain(labels, senders, receivers, edge_valid)
    raise ValueError("wl_hash_refine: unsupported device %s" % dev)


# --------------------------------------------------------------------- #
# compaction
# --------------------------------------------------------------------- #

def compact_ids(h1, h2, valid):
    """Dense ids for equal (h1, h2) pairs, ranked by (h1, h2) as unsigned
    32-bit values (``np.unique`` order of the packed u64), with counts.

    The counterpart of both ``compact_ids`` and ``host_compact_counts``
    of ``grakel_tpu/ops/wl.py``.  PyTorch has no uint64, so the pair
    packs into int64 as ``(h1 << 32 | h2) ^ (1 << 63)``, whose signed
    order is the unsigned order of the u64.  Invalid rows are masked
    explicitly: they all get the id after the last valid one and count
    as one more unique value, as the JAX package's all-ones sentinel
    does.  Returns (ids int32 [N], n_unique int, counts int64
    [n_unique])."""
    u1 = h1.to(torch.int64) & _M32
    u2 = h2.to(torch.int64) & _M32
    # == ((u1 << 32) | u2) ^ (1 << 63) read as int64, with no overflow
    key = (u1 - (1 << 31)) * (1 << 32) + u2
    valid = valid.to(torch.bool)
    uniq, inv, counts = torch.unique(key[valid], return_inverse=True,
                                     return_counts=True)
    nv = uniq.shape[0]
    ids = torch.full(key.shape, nv, dtype=torch.int32, device=key.device)
    ids[valid] = inv.to(torch.int32)
    n_invalid = key.shape[0] - int(valid.sum())
    if n_invalid:
        counts = torch.cat([counts, counts.new_tensor([n_invalid])])
        nv += 1
    return ids, nv, counts


def split_singletons(ids, counts, valid, gids, n_graphs):
    """Split a compacted labeling into (repeated-only relabeling,
    singleton diagonal correction).

    Labels occurring once contribute ONLY to the Gram diagonal (a
    singleton cannot co-occur in two graphs, nor twice in one), so the
    chunked counts-GEMM need only run over the repeated labels.  Returns
    ``(gram_labels int32[N], gram_valid bool[N], n_repeated,
    diag_correction f64[n_graphs])``."""
    ids = ids.to(torch.int64)
    valid = valid.to(torch.bool)
    rep = counts > 1
    node_rep = rep[ids] & valid
    remap = torch.cumsum(rep.to(torch.int64), 0) - 1
    gram_labels = torch.where(rep[ids], remap[ids],
                              torch.zeros_like(ids)).to(torch.int32)
    single = valid & ~node_rep
    g = gids.to(torch.int64)[single]
    diag = torch.bincount(g, minlength=n_graphs)[:n_graphs]
    return (gram_labels, node_rep, int(rep.sum()),
            diag.to(torch.float64))
