"""HadamardCode generations on tensors.

The counterpart of the device loop of
``grakel_tpu/kernels/hadamard_code.py`` (``_device_run`` with
``_row_hash``, XLA programs there).  A node's code is an int32 row of
width D (a power of two); generation 0 takes each node's initial code,
row ``row[v]`` of a small ``table`` (the rows of Hadamard matrices), and
each later generation

1. adds its out-neighbours' rows to each row (edge v -> u adds c[u] to
   c[v]; int32 adds that wrap mod 2^32, as XLA's ``segment_sum`` does);

and every generation

2. hashes each row, with its node's dimension tag, into two independent
   32-bit murmur-finalized hashes: every element is mixed with its
   column before the wrap-around sums, so permuted or shifted rows do not
   collide; the pair is written as K2's int64 compaction key
   (:func:`grakel_torch.ops.wl.key_hashes` unpacks it,
   :func:`~grakel_torch.ops.wl.compact_key_ids` ranks it).

:func:`hadamard_generations` runs the generations over a ``GraphBatch``'s
sender CSR and returns the keys [n_iter, N_pad].  CUDA tensors launch
the hand-written kernel K6 (``csrc/hadamard.cu``) on the routes
:func:`hc_plan` picks from shapes on the host (:func:`hc_route` for one
graph): the **graph** route runs every generation of whole graphs held
in a block's shared memory, one launch a call
(:func:`hadamard_graph_cuda`); graphs whose two code buffers do not fit
a block (:func:`k6_smem_bytes` over :data:`K6_SMEM_BUDGET`) take the
**round** route, one launch a generation from two code buffers in
device memory (:func:`hadamard_step_cuda`).  A batch may mix the two;
each graph takes one.  CPU tensors take
:func:`hadamard_generations_plain`, which loops
:func:`hadamard_step_plain`, int64 torch ops masked to 32 bits.
Wrap-around sums are order-free, so all give the JAX program's hashes
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .nh import _upload, chunk_table
from .wl import _fmix32, _mul32, _u_key

__all__ = ["row_hash_plain", "hadamard_step_plain",
           "hadamard_generations_plain", "hadamard_step_cuda",
           "hadamard_graph_cuda", "hadamard_generations", "hc_plan",
           "hc_route", "k6_smem_bytes", "K6_SMEM_BUDGET"]

_M32 = 0xFFFFFFFF
_POS1, _POS2 = 0x9E3779B9, 0xC2B2AE35
_MIX1, _MIX2 = 0x85EBCA6B, 0x27D4EB2F
_TAG1, _TAG2 = 0x9E3779B1, 0x7F4A7C15
_FIN1, _FIN2 = 0x165667B1, 0x7F4A7C15

# Graph route: a block's shared memory at most (two such blocks share an
# SM's 227 KB).  A graph beyond it takes the round route: at D = 64 a
# graph of more than ~180 vertices, at D = 1024 of more than ~11.
K6_SMEM_BUDGET = 96 * 1024
# threads of a graph-route block (csrc/hadamard.cu kGraphThreads)
K6_THREADS = 512
# the largest shared memory a block may ask for on an H100
_SMEM_MAX = 232448


# --------------------------------------------------------------------- #
# plain versions (CPU tensors; the references the kernel is held against)
# --------------------------------------------------------------------- #

def row_hash_plain(codes, dim_tag):
    """The int64 compaction key of each row of ``codes`` [N, D] (int32 or
    int64 holding int32 values) with its node's ``dim_tag`` [N] (u32
    values), in int64 torch ops: ``_row_hash`` of the JAX package over
    all D columns."""
    c = codes.to(torch.int64) & _M32
    j = torch.arange(c.shape[1], dtype=torch.int64, device=c.device)
    s1 = _fmix32(c ^ _mul32(j, _POS1), _MIX1).sum(1) & _M32
    s2 = _fmix32((c + _mul32(j, _POS2)) & _M32, _MIX2).sum(1) & _M32
    tag = dim_tag.to(torch.int64) & _M32
    h1 = _fmix32(s1 ^ _mul32(tag, _TAG1), _FIN1)
    h2 = _fmix32((s2 + _mul32(tag, _TAG2)) & _M32, _FIN2)
    return _u_key(h1, h2)


def hadamard_step_plain(codes, csr_offsets, csr_targets, dim_tag,
                        propagate):
    """One generation in plain PyTorch: ``(codes', key)``.  ``codes``
    int32 [N, D]; node v's out-neighbours are
    ``csr_targets[csr_offsets[v]:csr_offsets[v + 1]]``.  With
    ``propagate`` each row gains its out-neighbours' rows, summed in
    int64 and wrapped back to int32; without, ``codes'`` is ``codes``."""
    if propagate:
        n = codes.shape[0]
        off = csr_offsets.to(torch.int64)
        send = torch.repeat_interleave(
            torch.arange(n, device=codes.device), off[1:n + 1] - off[:n])
        c = codes.to(torch.int64)
        acc = c.clone()
        acc.index_add_(0, send, c[csr_targets[:send.shape[0]].to(
            torch.int64)])
        codes = (((acc + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)
    return codes, row_hash_plain(codes, dim_tag)


def hadamard_generations_plain(table, row, csr_offsets, csr_targets,
                               dim_tag, n_iter):
    """``n_iter`` generations in plain PyTorch: the int64 keys [n_iter,
    N].  Node v's initial code is ``table[row[v]]`` (int32 [T, D], row
    int [N]); each generation is one :func:`hadamard_step_plain`, the
    first without the neighbour sum."""
    codes = table.to(torch.int32)[row.to(torch.int64)]
    keys = []
    for it in range(n_iter):
        codes, key = hadamard_step_plain(codes, csr_offsets, csr_targets,
                                         dim_tag, it > 0)
        keys.append(key)
    return torch.stack(keys)


# --------------------------------------------------------------------- #
# K6's routes: the plan
# --------------------------------------------------------------------- #

def _smem_raw(nodes, edges, D):
    return (8 * D + 12) * nodes + 4 + 2 * edges


def k6_smem_bytes(nodes, edges, D):
    """Shared memory bytes of a graph-route block of ``nodes`` nodes and
    ``edges`` sender edges in all (ints, or int64 numpy arrays that
    broadcast): two uint32 code rows of D words, a row index, a tag and
    a CSR offset a node, one more offset, a 16-bit target an edge
    (csrc/hadamard.cu hadamard_graph's layout).  A chunk without edges
    keeps one code row a node."""
    nodes, edges = np.asarray(nodes), np.asarray(edges)
    raw = np.where(edges > 0, _smem_raw(nodes, edges, D),
                   (4 * D + 12) * nodes + 4)
    return (raw + 15) // 16 * 16


def hc_route(nodes, edges, D, budget=K6_SMEM_BUDGET):
    """K6's route for one graph of ``nodes`` vertices and ``edges``
    sender edges at code width ``D``: "graph" when its two code buffers
    fit a block's shared memory budget alone, else "round"."""
    if nodes < 1 << 16 and k6_smem_bytes(nodes, edges, D) <= budget:
        return "graph"
    return "round"


def hc_plan(n_nodes, n_edges, D, n_rows, budget=K6_SMEM_BUDGET):
    """K6's plan for a batch whose graphs have ``n_nodes`` vertices and
    ``n_edges`` sender edges (numpy [n_graphs], in batch order; nodes
    and edges of a graph contiguous, as ``GraphBatch`` lays them out)
    and ``n_rows`` rows in all (the padding rows after the graphs').

    Returns ``(chunks, round_graphs, smem)``: the ``ops.nh.chunk_table``
    of the runs of consecutive graphs on the graph route, each within
    ``budget`` bytes of shared memory, then chunks of the padding rows
    (no edges, graph ids n_graphs); int64 ids of the graphs on the round
    route (:func:`hc_route`); the shared memory bytes of the largest
    chunk.  Vectorised: a run's cumulative bytes cut into buckets of
    ``width = cap - s`` bytes, s the largest share of a graph packed with
    others, make the chunks, which then hold less than ``cap``; a graph
    of more than ``cap / 2`` bytes is a chunk of its own."""
    n_nodes = np.asarray(n_nodes, np.int64)
    n_edges = np.asarray(n_edges, np.int64)
    G = len(n_nodes)
    node_at = np.concatenate([[0], np.cumsum(n_nodes)])
    edge_at = np.concatenate([[0], np.cumsum(n_edges)])
    fits = (n_nodes < 1 << 16) & (
        k6_smem_bytes(n_nodes, n_edges, D) <= budget)
    # the layout is linear in nodes and edges: a chunk's bytes are a base
    # plus its graphs' shares; cap leaves room for the base and rounding
    share = np.where(fits, _smem_raw(n_nodes, n_edges, D) - _smem_raw(
        0, 0, D), 0)
    cap = budget // 16 * 16 - 32
    big = share > cap // 2
    s = int(share[fits & ~big].max(initial=0))
    cum = np.cumsum(share)
    # bytes since the run began (a run ends at each round-route graph)
    local = cum - np.maximum.accumulate(np.where(fits, 0, cum))
    bucket = local // max(cap - s, 1)
    first = np.ones(G, bool)
    first[1:] = (~fits[:-1] | big[:-1] | big[1:]
                 | (bucket[1:] != bucket[:-1]))
    first &= fits
    last = np.ones(G, bool)
    last[:-1] = first[1:] | ~fits[1:]
    last &= fits
    table = chunk_table(np.flatnonzero(first), np.flatnonzero(last) + 1,
                        node_at, edge_at)
    # padding rows: no edges, so a block hashes each once; 8 rows a warp
    # (D >= 32) or a lane (D < 32), in at most 64 KB
    step = min(8 * K6_THREADS // min(D, 32), 65536 // (4 * D + 12))
    p0 = np.arange(node_at[-1], n_rows, step, dtype=np.int64)
    p1 = np.minimum(p0 + step, n_rows)
    pad = np.stack([np.full_like(p0, G), np.full_like(p0, G), p0, p1,
                    np.full_like(p0, edge_at[-1]),
                    np.full_like(p0, edge_at[-1])], 1).astype(np.int32)
    table = np.concatenate([table, pad.reshape(-1, 6)])
    return table, np.flatnonzero(~fits), _table_smem(table, D)


def _table_smem(chunks, D):
    if not len(chunks):
        return 0
    _, _, v0, v1, e0, e1 = np.asarray(chunks, np.int64).T
    return int(k6_smem_bytes(v1 - v0, e1 - e0, D).max())


# --------------------------------------------------------------------- #
# K6 wrappers
# --------------------------------------------------------------------- #

def _is_i32(t, dev, dim):
    return (t.device == dev and t.dtype == torch.int32 and t.dim() == dim
            and t.is_contiguous())


def hadamard_step_cuda(codes, csr_offsets, csr_targets, dim_tag, propagate,
                       out=None, nodes=None, graph_mask=None, gids=None,
                       key=None):
    """Launch K6's round route (``csrc/hadamard.cu``): one generation over
    a CSR.

    ``csr_offsets`` [N + 1] non-decreasing from 0, ``csr_targets`` and
    ``dim_tag`` [N] are contiguous int32 CUDA tensors on one device; the
    CSR is trusted as K2 trusts it (``GraphBatch`` builds and checks it).
    ``nodes=(lo, hi)`` (default all N) are the nodes relabeled, and
    ``codes`` int32 [hi - lo, D] (D a power of two) their rows; their
    edges stay within the range.  ``graph_mask`` (bool [n_graphs]) with
    ``gids`` (int32 [N]) limits the call to the nodes of the graphs it
    marks.  With ``propagate`` the new rows go to ``out`` (a contiguous
    int32 tensor shaped like ``codes``, not ``codes``; allocated when
    None).  The keys go to ``key`` (int64 [N], contiguous; allocated when
    None) at the nodes relabeled.  Returns ``(codes', key)``:
    ``codes'`` is ``out`` when propagating, else ``codes``."""
    from .. import _build
    dev = codes.device
    N = dim_tag.shape[0] if dim_tag.dim() == 1 else -1
    lo, hi = (0, N) if nodes is None else (int(nodes[0]), int(nodes[1]))
    ok = (dev.type == "cuda" and _is_i32(codes, dev, 2)
          and _is_i32(csr_offsets, dev, 1) and _is_i32(csr_targets, dev, 1)
          and _is_i32(dim_tag, dev, 1) and 0 <= lo <= hi <= N < 1 << 30
          and csr_offsets.shape[0] == N + 1 and codes.shape[0] == hi - lo)
    D = codes.shape[1] if ok else 0
    if not (ok and D > 0 and D & (D - 1) == 0):
        raise ValueError("hadamard_step_cuda: need contiguous int32 CUDA "
                         "tensors on one device: codes [hi - lo, D] with D "
                         "a power of two, csr_offsets [N + 1], csr_targets "
                         "[E], dim_tag [N], 0 <= lo <= hi <= N < 2^30")
    if (graph_mask is None) != (gids is None) or graph_mask is not None \
            and not (graph_mask.device == dev
                     and graph_mask.dtype == torch.bool
                     and graph_mask.dim() == 1
                     and graph_mask.is_contiguous()
                     and _is_i32(gids, dev, 1) and gids.shape[0] == N):
        raise ValueError("hadamard_step_cuda: graph_mask (bool [n_graphs]) "
                         "and gids (int32 [N]) go together, contiguous, on "
                         "codes' device")
    if propagate:
        if out is None:
            out = torch.empty_like(codes)
        elif not (out.shape == codes.shape and _is_i32(out, dev, 2)
                  and out.data_ptr() != codes.data_ptr()):
            raise ValueError("hadamard_step_cuda: out must be a contiguous "
                             "int32 tensor shaped like codes, on its "
                             "device, and not codes itself")
    else:
        out = codes
    if key is None:
        key = torch.empty(N, dtype=torch.int64, device=dev)
    elif not (key.device == dev and key.dtype == torch.int64
              and key.shape == (N,) and key.is_contiguous()):
        raise ValueError("hadamard_step_cuda: key must be a contiguous "
                         "int64 [N] tensor on codes' device")
    _build.launch("grakel_hadamard_step", dev, codes.data_ptr(),
                  out.data_ptr(), csr_offsets.data_ptr(),
                  csr_targets.data_ptr(), dim_tag.data_ptr(),
                  None if gids is None else gids.data_ptr(),
                  None if graph_mask is None else graph_mask.data_ptr(),
                  key.data_ptr(), lo, hi,
                  0 if graph_mask is None else graph_mask.shape[0], D,
                  int(bool(propagate)))
    hadamard_step_cuda.launches += 1
    return out, key


hadamard_step_cuda.launches = 0


def hadamard_graph_cuda(table, row, dim_tag, csr_offsets, csr_targets,
                        chunks, key):
    """Launch K6's graph route (``csrc/hadamard.cu``): every generation of
    the rows in ``chunks`` (the table of :func:`hc_plan`, numpy int [C,
    6]), one block a chunk, in one launch.

    ``table`` int32 [T, D] (D a power of two), ``row`` int32 [N] (node
    v's initial code is ``table[row[v]]``; trusted to lie in [0, T)),
    ``dim_tag`` int32 [N], the CSR (``csr_offsets`` [N + 1], int32
    ``csr_targets``) and ``key`` int64 [n_iter, N], all contiguous CUDA
    tensors on one device: every generation's key of each chunk row is
    written, no other.  The chunk table is trusted as the CSR is: a
    chunk's nodes own its edge range and no edge leaves them
    (``GraphBatch`` checks that every edge stays in its graph)."""
    from .. import _build
    dev = table.device
    N = row.shape[0] if row.dim() == 1 else -1
    chunks = np.asarray(chunks, np.int64)
    if not (dev.type == "cuda" and _is_i32(table, dev, 2)
            and _is_i32(row, dev, 1) and _is_i32(dim_tag, dev, 1)
            and _is_i32(csr_offsets, dev, 1)
            and _is_i32(csr_targets, dev, 1) and key.device == dev
            and key.dtype == torch.int64 and key.dim() == 2
            and key.is_contiguous() and 0 <= N < 1 << 30
            and dim_tag.shape[0] == N and csr_offsets.shape[0] == N + 1
            and key.shape[1] == N and key.shape[0] >= 1
            and table.shape[1] > 0
            and table.shape[1] & (table.shape[1] - 1) == 0
            and chunks.ndim == 2 and chunks.shape[1] == 6):
        raise ValueError("hadamard_graph_cuda: need contiguous CUDA "
                         "tensors on one device: int32 table [T, D] with D "
                         "a power of two, row [N], dim_tag [N], "
                         "csr_offsets [N + 1] and csr_targets [E], int64 "
                         "key [n_iter >= 1, N], N < 2^30, and a chunk "
                         "table [C, 6]")
    if len(chunks) == 0:
        return key
    D = table.shape[1]
    _, _, v0, v1, e0, e1 = chunks.T
    smem = _table_smem(chunks, D)
    if not ((v0 <= v1).all() and (e0 <= e1).all() and v0.min() >= 0
            and v1.max() <= N and e0.min() >= 0
            and e1.max() <= csr_targets.shape[0]
            and (v1 - v0).max() < 1 << 16 and smem <= _SMEM_MAX):
        raise ValueError("hadamard_graph_cuda: chunk table out of range "
                         "(nodes or edges outside the batch, or a chunk "
                         "over 2^16 nodes or %d bytes of shared memory)"
                         % _SMEM_MAX)
    t = _upload(chunks.astype(np.int32), dev)
    _build.launch("grakel_hadamard_graph", dev, table.data_ptr(),
                  row.data_ptr(), dim_tag.data_ptr(), csr_offsets.data_ptr(),
                  csr_targets.data_ptr(), t.data_ptr(), len(chunks),
                  key.data_ptr(), N, D, key.shape[0], smem)
    hadamard_graph_cuda.launches += 1
    return key


hadamard_graph_cuda.launches = 0


def hadamard_generations(batch, table, row, dim_tag, n_iter):
    """The int64 compaction keys [n_iter, N_pad] of ``n_iter`` generations
    over ``batch``'s sender CSR: node v's initial code is
    ``table[row[v]]`` (int32 [T, D] and int32 [N_pad] on the batch's
    device; padding rows index a zero row), ``dim_tag`` [N_pad] its
    dimension tag.  CPU tensors take :func:`hadamard_generations_plain`.
    CUDA tensors take K6 on the routes of :func:`hc_plan`: one
    graph-route launch for the graphs that fit a block and the padding
    rows, and one round-route launch a generation for the others, from
    their rows gathered from the table into two buffers of this call."""
    off, tgt = batch.csr_offsets, batch.csr_targets
    dev = table.device
    tag = dim_tag.to(torch.int32).contiguous()
    if dev.type == "cpu":
        return hadamard_generations_plain(table, row, off, tgt, tag, n_iter)
    if dev.type != "cuda":
        raise ValueError("hadamard_generations: unsupported device %s" % dev)
    N = row.shape[0]
    key = torch.empty((n_iter, N), dtype=torch.int64, device=dev)
    chunks, rnd, _ = hc_plan(batch.n_nodes, batch.n_edges, table.shape[1],
                             N, K6_SMEM_BUDGET)
    if rnd.size:
        lo = int(batch.node_offsets[rnd[0]])
        hi = int(batch.node_offsets[rnd[-1] + 1])
        mask, gids = None, None
        if rnd.size < rnd[-1] - rnd[0] + 1:    # graph-route graphs between
            on = np.zeros(batch.n_graphs, bool)
            on[rnd] = True
            mask, gids = _upload(on, dev), batch.node_graph_ids
        codes, spare = table.index_select(0, row[lo:hi]), None
        for it in range(n_iter):
            nxt, _ = hadamard_step_cuda(codes, off, tgt, tag, it > 0,
                                        out=spare, nodes=(lo, hi),
                                        graph_mask=mask, gids=gids,
                                        key=key[it])
            if it > 0:
                spare, codes = codes, nxt
    hadamard_graph_cuda(table, row, tag, off, tgt, chunks, key)
    return key
