"""Edge-partitioned WL refinement of single large graphs, and the mixed
Gram that lets such graphs sit inside an ordinary dataset.

The counterpart of ``grakel_tpu/parallel/large_graph.py``.
``distributed_wl_gram`` (``parallel/wl.py``) gives whole graphs to
ranks, the layout for dataset Grams.  When ONE graph is too large for
that, this module splits its nodes and edges instead:

* nodes are block-partitioned over the mesh's ranks; each edge lives on
  its sender's rank, as a CSR of the rank's rows whose targets are
  global node indices (:class:`_EdgePartition`);
* each refinement step all-gathers the label shards
  (``all_gather_into_tensor``, 4 bytes a node), hashes the rank's rows
  against the global label vector with K2's second reach
  (``ops.wl.wl_hash_refine_rows``), and all-gathers the keys;
* one ``torch.unique`` on the device compacts the keys
  (``ops.wl.compact_key_ids``), the same ids on every rank.

K2's two reaches do bit-identical arithmetic, so a big graph's keys and
the small graphs' keys compact JOINTLY into one id space a generation:
that is how :func:`large_graph_wl_gram` gives a Gram over a dataset that
mixes huge graphs with ordinary ones equal to the single-device
``WeisfeilerLehman`` Gram.  As in the JAX package, every rank computes
that Gram whole (only the big graphs' hashing is split); its counts
Gram runs on the device, labels held by one node only into the
diagonal.  Not ported: the JAX package's ``host_hash_refine`` of the
small population (K2 runs it) and its dense-width route through
``cpu_gemm`` / ``fetch_gram`` (a workaround of its TPU's host link).
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import _sender_csr, bucket_size
from ..estimator import NotFittedError
from ..ops import wl as wl_ops
from ..ops.gram import chunk_plan, chunked_counts_gram_raw, count_dtype
from .mesh import gather_blocks

__all__ = ["edge_partitioned_wl_features", "large_graph_wl_gram",
           "LargeGraphWL"]


class _EdgePartition:
    """Plan of one graph over a P-way mesh: node blocks of ``npd =
    ceil(n / P)`` rows (``N_pad = npd * P``), each edge on its sender's
    rank, grouped by sender into one CSR whose targets are global node
    indices; :meth:`rank_csr` cuts rank p's rows out of it."""

    def __init__(self, g, P):
        n = g.n
        self.n = n
        self.P = P
        self.npd = npd = -(-n // P)
        self.N_pad = npd * P
        self.node_valid = np.zeros(self.N_pad, bool)
        self.node_valid[:n] = True
        send = np.asarray(g.senders, np.int64)
        recv = np.asarray(g.receivers, np.int64)
        for name, x in (("sender", send), ("receiver", recv)):
            if x.size and (int(x.min()) < 0 or int(x.max()) >= n):
                raise ValueError("an edge %s lies outside the graph's %d "
                                 "nodes" % (name, n))
        # any order within a sender: the hash sums wrap, so are
        # order-free (a stable sort costs ~3x at 2.3 M edges)
        order = np.argsort(send)
        self.offsets = np.zeros(self.N_pad + 1, np.int64)
        np.cumsum(np.bincount(send, minlength=self.N_pad),
                  out=self.offsets[1:])
        self.targets = recv[order].astype(np.int32)

    def rank_csr(self, p, device):
        """Rank p's rows ``[p * npd, (p + 1) * npd)``: (int32 offsets
        [npd + 1] from 0, int32 global targets), on ``device``."""
        lo, hi = p * self.npd, (p + 1) * self.npd
        e0, e1 = int(self.offsets[lo]), int(self.offsets[hi])
        off = (self.offsets[lo:hi + 1] - e0).astype(np.int32)
        return (torch.from_numpy(off).to(device),
                torch.from_numpy(self.targets[e0:e1]).to(device))


def _initial_labels(g, enum):
    """Shared-enumeration initial WL ids of one graph (``enum`` grows in
    order of appearance)."""
    labs = g.get_labels(label_type="vertex")
    out = np.zeros(g.n, np.int32)
    for v in range(g.n):
        l = labs[v]
        if l not in enum:
            enum[l] = len(enum)
        out[v] = enum[l]
    return out


def _histogram(ids, valid):
    """{label_id: count} via one bincount."""
    vals = np.asarray(ids)[np.asarray(valid)]
    if vals.size == 0:
        return {}
    cnt = np.bincount(vals.astype(np.int64))
    nz = np.nonzero(cnt)[0]
    return {int(l): int(cnt[l]) for l in nz}


def _refine_shard(mesh, part, csr, shard):
    """One edge-partitioned refinement: gather the label shards (int32
    [npd] a rank) into the global labels, hash this rank's rows against
    them (K2 reach 2), gather the keys: int64 [N_pad] on every rank."""
    labels = gather_blocks(mesh, shard)
    key = wl_ops.wl_hash_refine_rows(labels, *csr, mesh.rank * part.npd)
    return gather_blocks(mesh, key)


def edge_partitioned_wl_features(g, n_iter, mesh, axis="g"):
    """WL per-generation label histograms of one graph over a mesh.

    ``g``: :class:`grakel_torch.graph.Graph`.  Returns (a {label_id:
    count} dict a generation, the final label ids as numpy int32 [n]),
    the ids ranked by hash pair as the JAX package's ``host_compact``
    ranks them."""
    P, p = mesh.size, mesh.rank
    part = _EdgePartition(g, P)
    labels = np.full(part.N_pad, -1, np.int32)
    labels[:g.n] = _initial_labels(g, {})
    csr = part.rank_csr(p, mesh.device)
    valid = torch.from_numpy(part.node_valid).to(mesh.device)
    mine = slice(p * part.npd, (p + 1) * part.npd)
    feats = [_histogram(labels, part.node_valid)]
    cur = labels
    shard = torch.from_numpy(labels[mine].copy()).to(mesh.device)
    for _ in range(n_iter):
        ids = wl_ops.compact_key_ids(_refine_shard(mesh, part, csr, shard),
                                     valid)[0]
        shard = ids[mine]
        cur = ids.cpu().numpy()
        feats.append(_histogram(cur, part.node_valid))
    return feats, cur[:g.n]


def large_graph_wl_gram(graphs, n_iter, mesh, big_threshold=10000,
                        axis="g"):
    """Symmetric WL h=``n_iter`` subtree Gram for a dataset that may hold
    graphs too large for one device.

    Graphs with ``n >= big_threshold`` refine edge-partitioned over the
    mesh (K2 reach 2, two all-gathers a generation); the rest refine as
    one flat batch on every rank (K2 reach 1).  Each generation's keys of
    both populations compact jointly (one ``torch.unique``), so label
    ids live in one space and the Gram equals the single-device
    ``WeisfeilerLehman`` Gram exactly.  Returns float64 numpy [n, n] on
    every rank."""
    from ..kernels.base import normalize_input
    graphs = normalize_input(graphs)
    n_graphs, P, p, dev = len(graphs), mesh.size, mesh.rank, mesh.device
    big_idx = [i for i, g in enumerate(graphs) if g.n >= big_threshold]
    small_idx = [i for i, g in enumerate(graphs) if g.n < big_threshold]
    enum = {}

    # small population: one flat batch, its valid edges by sender
    sm = [graphs[i] for i in small_idx]
    sm_off = np.zeros(len(sm) + 1, np.int64)
    np.cumsum([g.n for g in sm], out=sm_off[1:])
    Ns = int(sm_off[-1])
    sm_labels = np.zeros(Ns, np.int32)
    sends, recvs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for k, g in enumerate(sm):
        o = sm_off[k]
        sm_labels[o:o + g.n] = _initial_labels(g, enum)
        sends.append(np.asarray(g.senders, np.int64) + o)
        recvs.append(np.asarray(g.receivers, np.int64) + o)
    off, tgt = _sender_csr(np.concatenate(sends), np.concatenate(recvs),
                           Ns, Ns)
    sm_csr = (torch.from_numpy(off).to(dev), torch.from_numpy(tgt).to(dev))

    # big population: edge-partitioned, rank p keeping its label shard
    parts, csrs, shards, streams = {}, {}, {}, [sm_labels]
    for i in big_idx:
        part = _EdgePartition(graphs[i], P)
        lab = np.full(part.N_pad, -1, np.int32)
        lab[:part.n] = _initial_labels(graphs[i], enum)
        parts[i], csrs[i] = part, part.rank_csr(p, dev)
        shards[i] = torch.from_numpy(
            lab[p * part.npd:(p + 1) * part.npd].copy()).to(dev)
        streams.append(lab)

    # the joint node stream: the small nodes, then each big graph's
    # padded rows
    gids = np.concatenate(
        [np.repeat(np.asarray(small_idx, np.int64),
                   [g.n for g in sm]).astype(np.int64)]
        + [np.full(parts[i].N_pad, i, np.int64) for i in big_idx])
    valid = np.concatenate([np.ones(Ns, bool)]
                           + [parts[i].node_valid for i in big_idx])
    gids_t = torch.from_numpy(gids).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)
    labels = torch.from_numpy(np.concatenate(streams)).to(dev)
    ones = torch.ones(len(gids), dtype=torch.float32, device=dev)
    dt = count_dtype((n_iter + 1) * max(g.n for g in graphs) ** 2)
    K = torch.zeros((n_graphs, n_graphs), dtype=dt, device=dev)
    diag = torch.zeros(n_graphs, dtype=torch.float64, device=dev)
    cur_small = torch.from_numpy(sm_labels).to(dev)
    gram_labels, gram_valid, width = labels, valid_t, max(len(enum), 1)
    for it in range(n_iter + 1):
        K = chunked_counts_gram_raw(gids_t, gram_labels, ones, gram_valid,
                                    n_graphs, *chunk_plan(width), K0=K)
        if it == n_iter:
            break
        keys = [wl_ops._wl_hash_refine_csr(cur_small, *sm_csr) if Ns
                else torch.zeros(0, dtype=torch.int64, device=dev)]
        keys += [_refine_shard(mesh, parts[i], csrs[i], shards[i])
                 for i in big_idx]
        ids, _, counts = wl_ops.compact_key_ids(torch.cat(keys), valid_t)
        gram_labels, gram_valid, n_rep, dc = wl_ops.split_singletons(
            ids, counts, valid_t, gids_t, n_graphs)
        diag += dc
        width = bucket_size(max(n_rep, 1))
        cur_small, o = ids[:Ns], Ns
        for i in big_idx:
            part = parts[i]
            shards[i] = ids[o + p * part.npd:o + (p + 1) * part.npd]
            o += part.N_pad
    torch.diagonal(K).add_(diag.to(K.dtype))
    return K.to(torch.float64).cpu().numpy()


class LargeGraphWL:
    """sklearn-style frontend over :func:`large_graph_wl_gram`.

    A drop-in WL subtree kernel for datasets that mix graphs too large
    for one device with ordinary ones: members with ``n >=
    big_threshold`` refine edge-partitioned over the mesh, the rest as
    one flat batch, and every Gram equals ``WeisfeilerLehman(n_iter=
    ...)`` exactly.  ``mesh`` None takes :func:`make_mesh` (every rank
    of the world, or a world of one).

    ``transform`` recomputes refinement over the fit + transform union:
    WL refinement is per-graph independent, so fit-time ids are
    reproduced and the rectangular block is exact (the single-device
    fast path's strategy)."""

    def __init__(self, n_iter=5, mesh=None, big_threshold=10000,
                 normalize=False, axis="g"):
        self.n_iter = n_iter
        self.mesh = mesh
        self.big_threshold = big_threshold
        self.normalize = normalize
        self.axis = axis

    def _mesh(self):
        if self.mesh is not None:
            return self.mesh
        from .mesh import make_mesh
        return make_mesh()

    def fit(self, X, y=None):
        from ..kernels.base import normalize_input
        self.X = normalize_input(X)
        return self

    def fit_transform(self, X, y=None):
        self.fit(X)
        K = large_graph_wl_gram(self.X, self.n_iter, self._mesh(),
                                big_threshold=self.big_threshold,
                                axis=self.axis)
        self._X_diag = np.diagonal(K).copy()
        if self.normalize:
            K = K / np.sqrt(np.outer(self._X_diag, self._X_diag))
        return K

    def transform(self, X):
        from ..kernels.base import normalize_input
        if not hasattr(self, "X"):
            raise NotFittedError("call fit before transform")
        Y = normalize_input(X)
        nx = len(self.X)
        Kfull = large_graph_wl_gram(list(self.X) + list(Y), self.n_iter,
                                    self._mesh(),
                                    big_threshold=self.big_threshold,
                                    axis=self.axis)
        K = Kfull[nx:, :nx]
        self._X_diag = np.diagonal(Kfull)[:nx].copy()
        self._Y_diag = np.diagonal(Kfull)[nx:].copy()
        if self.normalize:
            K = K / np.sqrt(np.outer(self._Y_diag, self._X_diag))
        return K

    def diagonal(self):
        if not hasattr(self, "_X_diag"):
            raise NotFittedError("call fit_transform before diagonal")
        if hasattr(self, "_Y_diag"):
            return self._X_diag, self._Y_diag
        return self._X_diag
