"""Weisfeiler-Lehman label refinement on tensors.

The counterpart of ``grakel_tpu/ops/wl.py``.  One refinement step:

1. hash each node's (own label, neighbour-label multiset) with a pair of
   independent 32-bit commutative multiset hashes (sums of mixed
   neighbour labels wrap mod 2^32, so the hash is order-free and matches
   the reference's sorted-credential semantics), packed into one int64
   compaction key per node: :func:`_wl_hash_refine_csr` over the valid
   edges grouped by sender (the CSR a ``GraphBatch`` builds and checks
   once), the hand-written CUDA kernel K2 for CUDA tensors and a plain
   int64 version for CPU tensors.  :func:`wl_hash_refine_rows` is K2's
   second reach: a block of rows of one edge-partitioned graph against
   its gathered global labels (``parallel.large_graph``).
   :func:`key_hashes` unpacks the pair.
   :func:`wl_hash_refine` is the same step on COO edges with a validity
   mask, the signature of the JAX function, returning the pair;
2. compact keys to dense ids ranked by (h1, h2) as unsigned values, with
   occurrence counts: :func:`compact_key_ids`, one ``torch.unique`` on
   the tensors' device.

Grams are label-permutation invariant, so ids ranked by hash value give
the reference's Grams.  Two distinct credentials colliding in BOTH
32-bit hashes has probability ~2^-64 per pair.
"""

from __future__ import annotations

import torch

__all__ = ["wl_hash_refine", "wl_hash_refine_rows", "key_hashes",
           "compact_key_ids", "compact_pairs", "split_singletons"]

_M32 = 0xFFFFFFFF
_SEED_E1, _SEED_E2 = 0x9E3779B9, 0x7F4A7C15
_MUL1, _MUL2 = 0x9E3779B9, 0x85EBCA6B
_FIN1, _FIN2 = 0x165667B1, 0x27D4EB2F


# --------------------------------------------------------------------- #
# plain versions (CPU tensors; the references the kernel is held against)
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


def _finalize(l, sum1, sum2):
    """int64 u32 hashes (h1, h2) from labels and neighbour sums."""
    h1 = _fmix32((_mul32(l, _MUL1) + sum1) & _M32, _FIN1)
    h2 = _fmix32((_mul32(l, _MUL2) + sum2) & _M32, _FIN2)
    return h1, h2


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
    h1, h2 = _finalize(l, sum1, sum2)
    return _as_i32(h1), _as_i32(h2)


def wl_hash_refine_csr_plain(labels, csr_offsets, csr_targets, row0=0):
    """Plain PyTorch WL hash step over a CSR of ``n = len(csr_offsets) -
    1`` rows (row v's out-neighbours are ``csr_targets[csr_offsets[v]:
    csr_offsets[v + 1]]``, indices into ``labels``, and its own label is
    ``labels[row0 + v]``), in int64 as :func:`wl_hash_refine_plain`.
    ``row0 = 0`` with a row a label is one batch's step; ``row0 > 0`` is a
    rank's block of rows of one edge-partitioned graph against the
    gathered global labels.  Returns the int64 compaction key of each row
    (:func:`key_hashes` unpacks it)."""
    l = labels.to(torch.int64) & _M32
    n = csr_offsets.shape[0] - 1
    off = csr_offsets.to(torch.int64)
    s = torch.repeat_interleave(torch.arange(n, device=l.device),
                                off[1:n + 1] - off[:n])
    nl = l[csr_targets[:s.shape[0]].to(torch.int64)]
    sum1 = torch.zeros(n, dtype=torch.int64, device=l.device)
    sum2 = torch.zeros(n, dtype=torch.int64, device=l.device)
    sum1.index_add_(0, s, _fmix32(nl, _SEED_E1))
    sum2.index_add_(0, s, _fmix32(nl, _SEED_E2))
    h1, h2 = _finalize(l[row0:row0 + n], sum1, sum2)
    return _u_key(h1, h2)


def _as_i32(u):
    """int64 holding u32 values -> int32 with the same bit pattern."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _u_key(u1, u2):
    """The compaction key of the hash pair (u1, u2), int64 holding u32
    values: ``((u1 << 32) | u2) ^ (1 << 63)`` read as int64, whose signed
    order is the unsigned order of the packed u64 (PyTorch has no
    uint64), computed with no overflow."""
    return (u1 - (1 << 31)) * (1 << 32) + u2


def key_hashes(key):
    """(h1, h2), the int32 bit patterns of the hash pair packed in the
    int64 compaction key ``key``."""
    return ((key >> 32).to(torch.int32) ^ torch.iinfo(torch.int32).min,
            _as_i32(key & _M32))


# --------------------------------------------------------------------- #
# K2 wrapper
# --------------------------------------------------------------------- #

def _k2_inputs_ok(labels, csr_offsets, csr_targets):
    """K2's arguments are contiguous 1-D int32 CUDA tensors on one
    device, fewer than 2^30 labels."""
    dev = labels.device
    ts = (labels, csr_offsets, csr_targets)
    return (dev.type == "cuda" and labels.shape[0] < 1 << 30
            and all(t.device == dev and t.dtype == torch.int32
                    and t.dim() == 1 and t.is_contiguous() for t in ts))


def wl_hash_refine_cuda(labels, csr_offsets, csr_targets):
    """Launch K2 (``csrc/wl_hash.cu``): one pass over a CSR.  Every
    argument must be a contiguous int32 CUDA tensor on one device: labels
    [N], csr_offsets [N + 1] non-decreasing from 0, csr_targets in
    [0, N).  The CSR is not checked here (that would cost a device sync
    a call): ``GraphBatch`` builds and checks it once, and
    :func:`csr_from_edges` builds it from checked edges.  Returns the
    int64 compaction key [N]."""
    from .. import _build
    dev = labels.device
    n = labels.shape[0]
    if not (_k2_inputs_ok(labels, csr_offsets, csr_targets)
            and csr_offsets.shape[0] == n + 1):
        raise ValueError("wl_hash_refine_cuda: need contiguous int32 CUDA "
                         "tensors on one device: labels [N], csr_offsets "
                         "[N + 1], csr_targets [E], N < 2^30")
    key = torch.empty(n, dtype=torch.int64, device=dev)
    _build.launch("grakel_wl_hash_refine", dev, labels.data_ptr(),
                  csr_offsets.data_ptr(), csr_targets.data_ptr(),
                  key.data_ptr(), n)
    wl_hash_refine_cuda.launches += 1
    return key


wl_hash_refine_cuda.launches = 0


def wl_hash_refine_rows_cuda(labels, csr_offsets, csr_targets, row0):
    """Launch K2's second reach (``grakel_wl_hash_refine_rows``): the
    rows ``[row0, row0 + n_rows)`` of ``labels`` (the gathered global
    label vector of one edge-partitioned graph), ``n_rows =
    len(csr_offsets) - 1``, whose out-edges ``csr_targets`` are global
    indices into ``labels``.  Contiguous int32 CUDA tensors on one
    device; the CSR is trusted as in :func:`wl_hash_refine_cuda`
    (``parallel.large_graph``'s partition checks the edges once).
    Returns the int64 compaction key [n_rows]."""
    from .. import _build
    dev = labels.device
    n = csr_offsets.shape[0] - 1
    if not (_k2_inputs_ok(labels, csr_offsets, csr_targets)
            and n >= 0 and 0 <= row0 and row0 + n <= labels.shape[0]):
        raise ValueError("wl_hash_refine_rows_cuda: need contiguous int32 "
                         "CUDA tensors on one device: labels [N], "
                         "csr_offsets [n_rows + 1], csr_targets [E], "
                         "0 <= row0, row0 + n_rows <= N < 2^30")
    key = torch.empty(n, dtype=torch.int64, device=dev)
    _build.launch("grakel_wl_hash_refine_rows", dev, labels.data_ptr(),
                  csr_offsets.data_ptr(), csr_targets.data_ptr(),
                  key.data_ptr(), n, int(row0))
    wl_hash_refine_rows_cuda.launches += 1
    return key


wl_hash_refine_rows_cuda.launches = 0


def wl_hash_refine_rows(labels, csr_offsets, csr_targets, row0):
    """K2's second reach: one WL refinement of the rows ``[row0, row0 +
    n_rows)`` of the global label vector ``labels``, their out-edges a
    CSR of global indices.  CUDA tensors launch the kernel
    (:func:`wl_hash_refine_rows_cuda`); CPU tensors take the plain
    version.  Returns the int64 compaction keys [n_rows]."""
    dev = labels.device
    if dev.type == "cuda":
        return wl_hash_refine_rows_cuda(labels, csr_offsets, csr_targets,
                                        row0)
    if dev.type == "cpu":
        return wl_hash_refine_csr_plain(labels, csr_offsets, csr_targets,
                                        row0)
    raise ValueError("wl_hash_refine_rows: unsupported device %s" % dev)


def _wl_hash_refine_csr(labels, csr_offsets, csr_targets):
    """One WL refinement over the valid edges grouped by sender (node v's
    out-neighbours are ``csr_targets[csr_offsets[v]:csr_offsets[v +
    1]]``), returning the int64 compaction key of each node's hash pair.
    The CSR is trusted: a ``GraphBatch``'s, or :func:`csr_from_edges`'s.

    CUDA tensors launch K2; CPU tensors take the plain version."""
    dev = labels.device
    if dev.type == "cuda":
        return wl_hash_refine_cuda(labels, csr_offsets, csr_targets)
    if dev.type == "cpu":
        return wl_hash_refine_csr_plain(labels, csr_offsets, csr_targets)
    raise ValueError("wl_hash_refine_csr: unsupported device %s" % dev)


def csr_from_edges(senders, receivers, edge_valid, n):
    """The valid edges grouped by sender, with device ops only: int32
    (offsets [n + 1], targets [E]).  Invalid edges sort past
    ``offsets[n]`` and are never read."""
    key = torch.where(edge_valid.to(torch.bool), senders.to(torch.int64), n)
    key, order = torch.sort(key, stable=True)
    targets = receivers.to(torch.int32)[order].contiguous()
    offsets = torch.searchsorted(
        key, torch.arange(n + 1, device=key.device)).to(torch.int32)
    return offsets, targets


def wl_hash_refine(labels, senders, receivers, edge_valid):
    """One WL refinement returning the raw (h1, h2) hash pairs as int32
    bit patterns, without id compaction.  Each node aggregates the labels
    of its OUT-neighbours (edge u->v contributes l(v) to u).

    CUDA tensors are grouped into a CSR on the device
    (:func:`csr_from_edges`) and launch K2; CPU tensors take the plain
    version."""
    dev = labels.device
    if dev.type == "cuda":
        n = labels.shape[0]
        if senders.shape[0]:   # K2 indexes with them: a bad id faults
            lo, hi = torch.aminmax(torch.stack([senders, receivers]))
            if int(lo) < 0 or int(hi) >= n:
                raise ValueError("wl_hash_refine: edge endpoints outside "
                                 "[0, %d)" % n)
        offsets, targets = csr_from_edges(senders, receivers, edge_valid, n)
        return key_hashes(wl_hash_refine_cuda(
            labels.to(torch.int32).contiguous(), offsets, targets))
    if dev.type == "cpu":
        return wl_hash_refine_plain(labels, senders, receivers, edge_valid)
    raise ValueError("wl_hash_refine: unsupported device %s" % dev)


# --------------------------------------------------------------------- #
# compaction
# --------------------------------------------------------------------- #

def compact_key_ids(key, valid):
    """Dense ids for equal int64 compaction keys, ranked by key (the
    unsigned order of the hash pairs), with counts.

    The counterpart of both ``compact_ids`` and ``host_compact_counts``
    of ``grakel_tpu/ops/wl.py``.  Invalid rows are masked explicitly:
    they all get the id after the last valid one and count as one more
    unique value, as the JAX package's all-ones sentinel does.  Returns
    (ids int32 [N], n_unique int, counts int64 [n_unique])."""
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


def compact_pairs(h1, h2, valid):
    """Dense ids for equal (h1, h2) pairs of u32 values held in int64
    tensors, ranked by the pair's unsigned order, with counts: the
    device counterpart of ``host_compact_counts`` in
    ``grakel_tpu/ops/wl.py`` (ShortestPath's (distance bits, label pair)
    triplet hashes), through :func:`compact_key_ids`."""
    return compact_key_ids(_u_key(h1, h2), valid)


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
