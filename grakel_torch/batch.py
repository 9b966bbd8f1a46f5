"""GraphBatch: padded, device-resident batch of graphs (flat layout).

All graphs of a dataset are packed into flat arrays with masks, so each
kernel's feature extraction runs as gather / scatter passes over the
whole batch at once.  The layout and the pad-size ladder are those of
``grakel_tpu/batch.py``, so a node or edge index means the same thing
in both packages; the tensors live on an explicit ``torch.device``.
The valid edges are also kept grouped by sender (a CSR, built and its
endpoints checked on the host at packing) for the WL hash kernel K2.

The dense ``[n_graphs, V_max, V_max]`` layout arrives with the port's
ShortestPath.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .profiling import host_span

__all__ = ["GraphBatch", "bucket_size", "enumerate_labels"]

# pad-size buckets: next value in this ladder >= requested size
_BUCKETS = [128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
            131072, 262144, 524288, 1048576, 2097152, 4194304]


def bucket_size(n, minimum=128):
    n = max(int(n), 1)
    for b in _BUCKETS:
        if b >= n and b >= minimum:
            return b
    # beyond the ladder: round up to a multiple of 128k
    step = 131072
    return ((n + step - 1) // step) * step


def enumerate_labels(labels, enum, extend=True):
    """Map hashable labels -> compact ints via mutable dict ``enum``.

    At fit time kernels pass a fresh dict (grown here); at transform time
    they pass the fit dict with ``extend=True`` so unseen labels get NEW ids
    past the fit range (the reference's ``_enum`` semantics).
    Returns an int32 numpy array.
    """
    out = np.empty(len(labels), dtype=np.int32)
    for i, lab in enumerate(labels):
        idx = enum.get(lab)
        if idx is None:
            if extend:
                idx = len(enum)
                enum[lab] = idx
            else:
                idx = -1
        out[i] = idx
    return out


def _sender_csr(send, recv, n_nodes, n_pad):
    """The valid edges grouped by sender, in edge order within a sender:
    int32 (offsets [n_pad + 1], targets [E]).  Raises ValueError when an
    endpoint lies outside [0, n_nodes), so kernels that index with the
    CSR (K2) need no check of their own."""
    for name, x in (("sender", send), ("receiver", recv)):
        if x.size and (int(x.min()) < 0 or int(x.max()) >= n_nodes):
            raise ValueError("GraphBatch: an edge %s lies outside the "
                             "batch's nodes [0, %d)" % (name, n_nodes))
    offsets = np.zeros(n_pad + 1, np.int32)
    np.cumsum(np.bincount(send, minlength=n_pad), out=offsets[1:])
    if send.size and not (send[1:] >= send[:-1]).all():
        recv = recv[np.argsort(send, kind="stable")]
    return offsets, np.ascontiguousarray(recv, dtype=np.int32)


@dataclasses.dataclass
class GraphBatch:
    """Padded batch.  Host metadata is numpy; per-item arrays are tensors
    on ``device``."""

    n_graphs: int
    node_graph_ids: torch.Tensor   # i32 [N_pad]; == n_graphs for padding
    node_mask: torch.Tensor        # bool [N_pad]
    node_labels: torch.Tensor      # i32 [N_pad]; 0 where unlabeled/pad
    senders: torch.Tensor          # i32 [E_pad] global node index; pad -> N_pad-1
    receivers: torch.Tensor        # i32 [E_pad]
    edge_mask: torch.Tensor        # bool [E_pad]
    edge_weights: torch.Tensor     # f32 [E_pad]; 0 on padding
    edge_labels: torch.Tensor      # i32 [E_pad]
    edge_graph_ids: torch.Tensor   # i32 [E_pad]; == n_graphs for padding
    csr_offsets: torch.Tensor      # i32 [N_pad+1] valid edges by sender
    csr_targets: torch.Tensor      # i32 [E] their receivers
    n_nodes: np.ndarray            # i64 [n_graphs]
    n_edges: np.ndarray            # i64 [n_graphs]
    node_offsets: np.ndarray       # i64 [n_graphs+1] start of each graph's nodes
    num_node_labels: int
    num_edge_labels: int
    device: torch.device

    @property
    def total_nodes(self) -> int:
        return int(self.node_offsets[-1])

    @property
    def total_edges(self) -> int:
        return int(self.n_edges.sum())

    @property
    def max_nodes(self) -> int:
        return int(self.n_nodes.max()) if self.n_graphs else 0

    @classmethod
    def from_graphs(cls, graphs, node_label_enum=None, edge_label_enum=None,
                    extend_enums=True, node_pad=None, edge_pad=None,
                    device=None):
        """Pack a list of :class:`grakel_torch.graph.Graph` into one batch
        on ``device`` (None: the ambient device, else cuda; see
        :func:`grakel_torch.device.resolve_device`).

        ``node_label_enum`` / ``edge_label_enum`` are mutable dicts mapping
        raw labels to compact ids (see :func:`enumerate_labels`); pass the
        fit-time dicts at transform time for consistent ids.
        """
        # the host's build, ending before the upload
        with host_span("batch"):
            n = len(graphs)
            n_nodes = np.array([g.n for g in graphs], dtype=np.int64)
            n_edges = np.array([len(g.senders) for g in graphs],
                               dtype=np.int64)
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(n_nodes, out=offsets[1:])
            N = int(offsets[-1])
            E = int(n_edges.sum())
            # +1: reserve a sink pad node
            N_pad = node_pad or bucket_size(N + 1)
            E_pad = edge_pad or bucket_size(max(E, 1))

            node_gid = np.full(N_pad, n, dtype=np.int32)
            node_msk = np.zeros(N_pad, dtype=bool)
            send = np.full(E_pad, N_pad - 1, dtype=np.int32)
            recv = np.full(E_pad, N_pad - 1, dtype=np.int32)
            ew = np.zeros(E_pad, dtype=np.float32)
            edge_gid = np.full(E_pad, n, dtype=np.int32)
            edge_msk = np.zeros(E_pad, dtype=bool)

            node_gid[:N] = np.repeat(np.arange(n, dtype=np.int32), n_nodes)
            node_msk[:N] = True
            edge_off = np.repeat(offsets[:-1], n_edges).astype(np.int32)
            if E:
                send[:E] = np.concatenate(
                    [g.senders for g in graphs]) + edge_off
                recv[:E] = np.concatenate(
                    [g.receivers for g in graphs]) + edge_off
                ew[:E] = np.concatenate([g.weights for g in graphs])
                edge_gid[:E] = np.repeat(np.arange(n, dtype=np.int32),
                                         n_edges)
                edge_msk[:E] = True
            csr_offsets, csr_targets = _sender_csr(send[:E], recv[:E], N,
                                                   N_pad)
            # no edge leaves its graph (K4 holds whole graphs in a block)
            own_end = edge_off + np.repeat(n_nodes, n_edges)
            for name, x in (("sender", send[:E]), ("receiver", recv[:E])):
                if not ((x >= edge_off) & (x < own_end)).all():
                    raise ValueError("GraphBatch: an edge %s lies outside "
                                     "its graph's nodes" % name)
            if node_label_enum is None:
                node_label_enum = {}
            if edge_label_enum is None:
                edge_label_enum = {}

            # vectorized fast path: fresh enums + all-integer node labels
            # + no edge labels -> one np.unique instead of per-item dict
            # ops (ids come out value-ordered; Grams are id-permutation
            # invariant)
            nl = el = None
            if extend_enums and not node_label_enum \
                    and not edge_label_enum \
                    and all(not g.edge_labels for g in graphs):
                arrs = [g.numeric_node_label_array() for g in graphs]
                if all(a is not None for a in arrs):
                    raw = (np.concatenate(arrs) if arrs
                           else np.zeros(0, np.int64))
                    uniq, nl = np.unique(raw, return_inverse=True)
                    nl = nl.astype(np.int32)
                    node_label_enum.update(
                        {int(u): i for i, u in enumerate(uniq)})
                    el = np.zeros(E, dtype=np.int32)
                    if E:
                        edge_label_enum[0] = 0
            if nl is None:
                node_lab_raw = []
                edge_lab_raw = []
                for g in graphs:
                    labs = g.node_labels
                    node_lab_raw.extend(labs.get(v, 0) for v in range(g.n))
                    elabs = g.edge_labels
                    edge_lab_raw.extend(
                        elabs.get((int(s), int(r)), 0)
                        for s, r in zip(g.senders, g.receivers))
                nl = enumerate_labels(node_lab_raw, node_label_enum,
                                      extend_enums)
                el = enumerate_labels(edge_lab_raw, edge_label_enum,
                                      extend_enums)
            node_lab = np.zeros(N_pad, dtype=np.int32)
            node_lab[:N] = nl
            edge_lab = np.zeros(E_pad, dtype=np.int32)
            edge_lab[:E] = el

        device = resolve_device(device)

        def conv(a):
            return torch.from_numpy(a).to(device)

        return cls(
            n_graphs=n,
            node_graph_ids=conv(node_gid),
            node_mask=conv(node_msk),
            node_labels=conv(node_lab),
            senders=conv(send),
            receivers=conv(recv),
            edge_mask=conv(edge_msk),
            edge_weights=conv(ew),
            edge_labels=conv(edge_lab),
            edge_graph_ids=conv(edge_gid),
            csr_offsets=conv(csr_offsets),
            csr_targets=conv(csr_targets),
            n_nodes=n_nodes,
            n_edges=n_edges,
            node_offsets=offsets,
            num_node_labels=len(node_label_enum),
            num_edge_labels=len(edge_label_enum),
            device=device,
        )
