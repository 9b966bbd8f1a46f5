"""NeighborhoodHash rounds on tensors.

The counterpart of ``grakel_tpu/kernels/neighborhood_hash.py:_nh_rounds``
(an XLA program there).  One round relabels every node from its own label
and its out-neighbours' labels (edge u -> v: v is a neighbour of u), all
in ``bits``-bit words:

* simple:          NH(u) = ROT1(l(u)) XOR (XOR over neighbour labels);
* count_sensitive: NH(u) = ROT1(l(u)) XOR (XOR over the distinct masked
  neighbour labels l, with count o, of ROT(l XOR o, o));

a node is poisoned (invalid) once its own label or any neighbour's is
invalid (a label unseen at fit), and poisoned nodes are still relabeled.
After each round every valid node adds one to its graph's histogram at
its new label.

:func:`nh_rounds` runs R rounds over a ``GraphBatch``'s sender CSR.
CUDA tensors launch the hand-written kernel K4 (``csrc/nh_hash.cu``) on
the routes :func:`nh_plan` picks from shapes on the host
(:func:`nh_route` for one graph): the **graph** route runs all R rounds
of whole graphs held in a block's shared memory, one launch a call
(:func:`nh_graph_cuda`); graphs that do not fit a block
(:func:`k4_smem_bytes` over :data:`K4_SMEM_BUDGET`) take the **round**
route, one launch a round from global memory (:func:`nh_round_cuda`).
A batch may mix the two; each graph takes one.  CPU tensors take
:func:`nh_rounds_plain`, the JAX program's own method (bit-plane parity
for the XOR aggregation, an edge sort by (node, label) with run lengths
for the count-sensitive fold) in int64 torch ops.  All give int32
histograms [R, n_graphs, 2^bits].

The JAX program sorts by the key ``send * 2^bits + label`` in uint32,
which wraps once N * 2^bits reaches 2^32; the plain version's key is
int64 and K4 keys nothing, so the packages can differ only there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nh_rounds", "nh_rounds_plain", "nh_round_cuda", "nh_graph_cuda",
           "nh_plan", "nh_route", "chunk_table", "k4_smem_bytes", "rot_plain",
           "xor_segment_plain", "K4_SMEM_BUDGET", "K4_CHUNK_NODES",
           "K4_HUB_DEGREE"]

_M32 = 0xFFFFFFFF

# Graph route: a block's shared memory at most (two such blocks share an
# SM's 227 KB).  A graph beyond it would keep one SM busy while the round
# route spreads its nodes over all of them: the REDDIT-B stand-in's
# largest graph (3782 vertices, 8.7k edges) needs 72.5 KB at bits = 8,
# graphs of 5500-6500 vertices at connectivity 0.001-0.002 170-230 KB.
K4_SMEM_BUDGET = 96 * 1024
# Graph route: a chunk takes whole graphs while it holds at most this
# many nodes (one a thread of the 256-thread block); a larger graph that
# fits the budget is a chunk of its own.
K4_CHUNK_NODES = 256
# Out-degree above which a warp, not a thread, folds a node: a thread
# spends deg (simple) or deg^2 (count_sensitive) steps, and its warp waits
# for its slowest lane; a warp spends ceil(deg / 32) or deg ceil(deg /
# 32) steps and a 5-step butterfly.  16 and 8 put a node on the warp once
# the thread's steps pass about twice the warp's.
K4_HUB_DEGREE = {False: 16, True: 8}
# the largest shared memory a block may ask for on an H100
_SMEM_MAX = 232448


def rot_plain(x, d, bits):
    """ROT of ``x`` by ``d`` in ``bits``-bit words, on int64 tensors
    holding u32 values: ``_rot`` of the JAX package exactly, including
    its ``d % bits == 0`` case, which returns ``x`` unmasked."""
    mask = (1 << bits) - 1
    m = torch.as_tensor(d, dtype=torch.int64, device=x.device) % bits
    r = ((x << m) & mask) | ((x & mask) >> torch.where(m > 0, bits - m, 0))
    return torch.where(m > 0, r, x)


def xor_segment_plain(values, segment_ids, num_segments, bits):
    """XOR of the low ``bits`` bits of int64 ``values`` per segment, by
    bit-plane parity (one ``index_add_`` a plane), as ``_xor_segment`` of
    the JAX package.  Returns int64 [num_segments]."""
    out = torch.zeros(num_segments, dtype=torch.int64, device=values.device)
    for b in range(bits):
        s = torch.zeros(num_segments, dtype=torch.int64,
                        device=values.device)
        s.index_add_(0, segment_ids, (values >> b) & 1)
        out |= (s & 1) << b
    return out


def _senders(csr_offsets, n):
    off = csr_offsets.to(torch.int64)
    return torch.repeat_interleave(torch.arange(n, device=off.device),
                                   off[1:n + 1] - off[:n])


def _histogram(hist, gids, lab, valid, L):
    """hist[g, l] += 1 for every valid node of graph g with label l."""
    seg = gids[valid].to(torch.int64) * L + lab[valid]
    hist.view(-1).index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))


def nh_rounds_plain(lab, lab_valid, gids, csr_offsets, csr_targets,
                    n_graphs, R, bits, count_sensitive):
    """R NeighborhoodHash rounds in plain PyTorch (int64), on any device.

    ``lab`` int32 [N] (u32 bit patterns), ``lab_valid`` bool [N] (False
    on padding nodes too), ``gids`` int32 [N] (a padding node may carry
    any id: it is never valid), and the sender CSR over the N nodes.
    Returns int32 histograms [R, n_graphs, 2^bits]."""
    n = lab.shape[0]
    L = 1 << bits
    mask = L - 1
    send = _senders(csr_offsets, n)
    recv = csr_targets[:send.shape[0]].to(torch.int64)
    l = lab.to(torch.int64) & _M32
    valid = lab_valid.to(torch.bool)
    hists = torch.zeros((R, n_graphs, L), dtype=torch.int32,
                        device=lab.device)
    for r in range(R):
        bad = torch.zeros(n, dtype=torch.int64, device=l.device)
        bad.index_add_(0, send, (~valid[recv]).to(torch.int64))
        valid = valid & (bad == 0)
        if not count_sensitive:
            agg = xor_segment_plain(l[recv], send, n, bits)
        else:
            # distinct (node, masked neighbour label) runs with their
            # lengths o, each folded as ROT(l ^ o, o)
            key, o = torch.unique(send * L + (l[recv] & mask),
                                  return_counts=True)
            agg = xor_segment_plain(rot_plain((key & mask) ^ o, o, bits),
                                    key >> bits, n, bits)
        l = (rot_plain(l & mask, 1, bits) ^ agg) & mask
        _histogram(hists[r], gids, l, valid, L)
    return hists


def k4_smem_bytes(nodes, edges, graphs, bits):
    """Shared memory bytes of a graph-route block of ``graphs`` graphs
    with ``nodes`` nodes and ``edges`` sender edges in all (ints, or
    int64 numpy arrays that broadcast): two int32 counter rows a graph,
    two label words, an int32 CSR offset, a 16-bit graph id a node, a
    16-bit target an edge (csrc/nh_hash.cu nh_graph's layout)."""
    return (_smem_raw(nodes, edges, graphs, bits) + 15) // 16 * 16


def _smem_raw(nodes, edges, graphs, bits):
    return (8 << bits) * graphs + 14 * nodes + 4 + 2 * edges


def nh_route(nodes, edges, bits, budget=K4_SMEM_BUDGET):
    """K4's route for one graph of ``nodes`` vertices and ``edges``
    sender edges: "graph" when it fits a block's shared memory budget
    alone, else "round"."""
    if nodes < 1 << 16 and k4_smem_bytes(nodes, edges, 1, bits) <= budget:
        return "graph"
    return "round"


def nh_plan(n_nodes, n_edges, bits, chunk_nodes=K4_CHUNK_NODES,
            budget=K4_SMEM_BUDGET):
    """K4's plan for a batch whose graphs have ``n_nodes`` vertices and
    ``n_edges`` sender edges (numpy [n_graphs], in batch order; nodes
    and edges of a graph contiguous, as ``GraphBatch`` lays them out).

    Returns ``(chunks, round_graphs, smem)``: the :func:`chunk_table` of
    the runs of consecutive graphs on the graph route that the greedy
    walk in batch order packs while a run holds at most ``chunk_nodes``
    nodes (a larger graph alone) and fits ``budget`` bytes of shared
    memory; int64 ids of the graphs on the round route
    (:func:`nh_route`); the shared memory bytes of the largest chunk (0
    without chunks)."""
    n_nodes = np.asarray(n_nodes, np.int64)
    n_edges = np.asarray(n_edges, np.int64)
    node_at = np.concatenate([[0], np.cumsum(n_nodes)])
    edge_at = np.concatenate([[0], np.cumsum(n_edges)])
    fits = (n_nodes < 1 << 16) & (
        k4_smem_bytes(n_nodes, n_edges, 1, bits) <= budget)
    # the layout is linear in nodes, edges and graphs: a chunk's bytes are
    # a base plus its graphs' shares, within the budget's whole 16 bytes
    base = _smem_raw(0, 0, 0, bits)
    share = (_smem_raw(n_nodes, n_edges, 1, bits) - base).tolist()
    cap = budget // 16 * 16 - base
    chunks, smem = [], 0
    run = None                  # the open chunk: [g0, nodes, bytes]
    for g, (nv, c, ok) in enumerate(zip(n_nodes.tolist(), share,
                                        fits.tolist())):
        if run is not None:
            if ok and run[1] + nv <= chunk_nodes and run[2] + c <= cap \
                    and g + 1 - run[0] < 1 << 16:
                run[1] += nv
                run[2] += c
                continue
            chunks.append((run[0], g))
            run = None
        if ok:
            run = [g, nv, c]
    if run is not None:
        chunks.append((run[0], len(n_nodes)))
    table = chunk_table(*np.array(chunks, np.int64).reshape(-1, 2).T,
                        node_at, edge_at)
    if chunks:
        g0, g1, v0, v1, e0, e1 = table.T.astype(np.int64)
        smem = int(k4_smem_bytes(v1 - v0, e1 - e0, g1 - g0, bits).max())
    return table, np.flatnonzero(~fits), smem


def chunk_table(lo, hi, node_at, edge_at):
    """The int32 [C, 6] chunk table of the graph runs ``[lo[c], hi[c])``
    (int64 numpy) of a batch whose graphs' nodes and CSR edges start at
    ``node_at`` and ``edge_at`` (length n_graphs + 1): rows ``(g0, g1,
    node0, node1, edge0, edge1)``, ordered by decreasing node count
    (blocks start in about that order, so the largest chunks do not
    finish last)."""
    order = np.argsort(node_at[lo] - node_at[hi], kind="stable")
    lo, hi = lo[order], hi[order]
    return np.stack([lo, hi, node_at[lo], node_at[hi], edge_at[lo],
                     edge_at[hi]], 1).astype(np.int32).reshape(-1, 6)


_COPY_STREAMS = {}


def _upload(a, dev):
    """A host array on ``dev``, for the current stream's next launch: a
    pinned copy sent on a copy stream of its own, which the current
    stream then waits for.  The copy does not queue behind the work
    already on the current stream (in that stream, it and the launch
    after it added ~7 us to each back-to-back K4 call on an H100), and
    the host never waits (a pageable copy would wait for the device)."""
    host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
    main = torch.cuda.current_stream(dev)
    side = _COPY_STREAMS.get(main.device)
    if side is None:
        side = _COPY_STREAMS[main.device] = torch.cuda.Stream(main.device)
    with torch.cuda.stream(side):
        t = host.to(main.device, non_blocking=True)
    main.wait_stream(side)
    t.record_stream(main)
    return t


def _check_round_inputs(name, lab, lab_valid, gids, csr_offsets,
                        csr_targets, bits):
    dev = lab.device
    n = lab.shape[0]
    ts = (lab, lab_valid, gids, csr_offsets, csr_targets)
    types = (torch.int32, torch.bool, torch.int32, torch.int32, torch.int32)
    if not (dev.type == "cuda"
            and all(t.device == dev and t.dtype == d and t.is_contiguous()
                    and t.dim() == 1 for t, d in zip(ts, types))
            and lab_valid.shape[0] == gids.shape[0] == n
            and csr_offsets.shape[0] == n + 1 and n < 1 << 30
            and 1 <= bits <= 30):
        raise ValueError("%s: need contiguous CUDA tensors on one device: "
                         "int32 lab [N], bool lab_valid [N], int32 gids [N], "
                         "int32 csr_offsets [N + 1] and csr_targets [E], "
                         "1 <= bits <= 30, N < 2^30" % name)


def _hub(hub_degree, count_sensitive):
    h = K4_HUB_DEGREE[bool(count_sensitive)] if hub_degree is None \
        else int(hub_degree)
    return min(max(h, 0), (1 << 31) - 1)


def nh_round_cuda(lab, lab_valid, gids, csr_offsets, csr_targets, hist,
                  bits, count_sensitive, graph_mask=None, nodes=None,
                  hub_degree=None):
    """Launch K4's round route (``csrc/nh_hash.cu``): one NeighborhoodHash
    round.

    ``lab`` int32 [N], ``lab_valid`` bool [N], ``gids`` int32 [N] (ids
    of valid nodes in [0, n_graphs)), ``csr_offsets`` int32 [N + 1],
    ``csr_targets`` int32 [E] and ``hist`` int32 [n_graphs, 2^bits], all
    contiguous CUDA tensors on one device.  The CSR is trusted, as K2's
    (``GraphBatch`` checks it once).  ``nodes=(lo, hi)`` limits the
    round to those nodes (default all); ``graph_mask`` (bool [n_graphs]
    there) limits it to the nodes of the graphs it marks, whose entries
    alone the returned tensors then hold.  A node of out-degree above
    ``hub_degree`` (default :data:`K4_HUB_DEGREE`) is folded by a warp.
    Adds the round's counts into ``hist`` and returns the new (labels,
    validity)."""
    from .. import _build
    _check_round_inputs("nh_round_cuda", lab, lab_valid, gids, csr_offsets,
                        csr_targets, bits)
    dev, n = lab.device, lab.shape[0]
    lo, hi = (0, n) if nodes is None else (int(nodes[0]), int(nodes[1]))
    if not (hist.device == dev and hist.dtype == torch.int32
            and hist.is_contiguous() and hist.dim() == 2
            and hist.shape[1] == 1 << bits and 0 <= lo <= hi <= n
            and (graph_mask is None
                 or (graph_mask.device == dev
                     and graph_mask.dtype == torch.bool
                     and graph_mask.is_contiguous()
                     and graph_mask.shape == (hist.shape[0],)))):
        raise ValueError("nh_round_cuda: need int32 hist [n_graphs, 2^bits] "
                         "and bool graph_mask [n_graphs], contiguous, on "
                         "lab's device, and 0 <= lo <= hi <= N")
    new_lab = torch.empty_like(lab)
    new_valid = torch.empty_like(lab_valid)
    _build.launch("grakel_nh_round", dev, lab.data_ptr(),
                  lab_valid.data_ptr(), gids.data_ptr(),
                  csr_offsets.data_ptr(), csr_targets.data_ptr(),
                  None if graph_mask is None else graph_mask.data_ptr(),
                  new_lab.data_ptr(), new_valid.data_ptr(), hist.data_ptr(),
                  lo, hi, hist.shape[0], bits, int(bool(count_sensitive)),
                  _hub(hub_degree, count_sensitive))
    nh_round_cuda.launches += 1
    return new_lab, new_valid


nh_round_cuda.launches = 0


def nh_graph_cuda(lab, lab_valid, gids, csr_offsets, csr_targets, chunks,
                  hist, bits, count_sensitive, hub_degree=None):
    """Launch K4's graph route (``csrc/nh_hash.cu``): all R rounds of the
    graphs in ``chunks`` (the table of :func:`nh_plan`, numpy int [C,
    6]), one block a chunk, in one launch.

    ``lab`` .. ``csr_targets`` as for :func:`nh_round_cuda`; ``hist``
    int32 [R, n_graphs, 2^bits], contiguous, on their device: every bin of
    the chunks' rows is written, no other.  The table is trusted as the
    CSR is: a chunk's graphs own its node and edge ranges and no edge
    leaves them (``GraphBatch`` checks that every edge stays in its
    graph)."""
    from .. import _build
    _check_round_inputs("nh_graph_cuda", lab, lab_valid, gids, csr_offsets,
                        csr_targets, bits)
    dev, n = lab.device, lab.shape[0]
    chunks = np.asarray(chunks, np.int64)
    if not (hist.device == dev and hist.dtype == torch.int32
            and hist.is_contiguous() and hist.dim() == 3
            and hist.shape[0] >= 1 and hist.shape[2] == 1 << bits
            and chunks.ndim == 2 and chunks.shape[1] == 6):
        raise ValueError("nh_graph_cuda: need int32 hist [R >= 1, n_graphs, "
                         "2^bits], contiguous, on lab's device, and a chunk "
                         "table [C, 6]")
    if len(chunks) == 0:
        return hist
    g0, g1, v0, v1, e0, e1 = chunks.T
    smem = int(k4_smem_bytes(v1 - v0, e1 - e0, g1 - g0, bits).max())
    if not ((g0 < g1).all() and (v0 <= v1).all() and (e0 <= e1).all()
            and g0.min() >= 0 and g1.max() <= hist.shape[1]
            and v0.min() >= 0 and v1.max() <= n and e0.min() >= 0
            and e1.max() <= csr_targets.shape[0]
            and (v1 - v0).max() < 1 << 16 and (g1 - g0).max() < 1 << 16
            and smem <= _SMEM_MAX):
        raise ValueError("nh_graph_cuda: chunk table out of range (graphs, "
                         "nodes or edges outside the batch, or a chunk over "
                         "2^16 nodes or graphs or %d bytes of shared "
                         "memory)" % _SMEM_MAX)
    table = _upload(chunks.astype(np.int32), dev)
    _build.launch("grakel_nh_graph", dev, lab.data_ptr(),
                  lab_valid.data_ptr(), gids.data_ptr(),
                  csr_offsets.data_ptr(), csr_targets.data_ptr(),
                  table.data_ptr(), len(chunks), hist.data_ptr(),
                  hist.shape[1], hist.shape[0], bits,
                  int(bool(count_sensitive)),
                  _hub(hub_degree, count_sensitive), smem)
    nh_graph_cuda.launches += 1
    return hist


nh_graph_cuda.launches = 0


def nh_rounds(batch, lab, lab_valid, n_graphs, R, bits, count_sensitive):
    """R NeighborhoodHash rounds over ``batch``'s sender CSR: int32
    histograms [R, n_graphs, 2^bits] on the batch's device.  ``lab``
    int32 [N_pad] and ``lab_valid`` bool [N_pad] (False on padding) live
    there too.  CPU tensors take :func:`nh_rounds_plain`.  CUDA tensors
    (``n_graphs`` the batch's graph count) take K4 on the routes of
    :func:`nh_plan`: one graph-route launch for the graphs that fit a
    block, and R round-route launches for the others, into their own
    zeroed rows."""
    gids = batch.node_graph_ids
    csr = (batch.csr_offsets, batch.csr_targets)
    dev = lab.device
    if dev.type == "cpu":
        return nh_rounds_plain(lab, lab_valid, gids, *csr, n_graphs, R,
                               bits, count_sensitive)
    if dev.type != "cuda":
        raise ValueError("nh_rounds: unsupported device %s" % dev)
    if n_graphs != batch.n_graphs:
        raise ValueError("nh_rounds: n_graphs %d is not the batch's %d"
                         % (n_graphs, batch.n_graphs))
    hists = torch.empty((R, n_graphs, 1 << bits), dtype=torch.int32,
                        device=dev)
    if R == 0 or n_graphs == 0:
        return hists
    chunks, rnd, _ = nh_plan(batch.n_nodes, batch.n_edges, bits,
                             K4_CHUNK_NODES, K4_SMEM_BUDGET)
    if rnd.size:
        nodes, mask = (0, lab.shape[0]), None
        if rnd.size == n_graphs:
            hists.zero_()
        else:
            on = np.zeros(n_graphs, bool)
            on[rnd] = True
            mask = _upload(on, dev)
            hists.masked_fill_(mask[None, :, None], 0)
            nodes = (int(batch.node_offsets[rnd[0]]),
                     int(batch.node_offsets[rnd[-1] + 1]))
        lr, vr = lab, lab_valid
        for r in range(R):
            lr, vr = nh_round_cuda(lr, vr, gids, *csr, hists[r], bits,
                                   count_sensitive, graph_mask=mask,
                                   nodes=nodes)
    if len(chunks):
        nh_graph_cuda(lab, lab_valid, gids, *csr, chunks, hists, bits,
                      count_sensitive)
    return hists
