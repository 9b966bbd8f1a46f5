"""Distributed WL subtree Gram: graph-sharded refinement + ring tiling.

The counterpart of ``grakel_tpu/parallel/wl.py``: the single-device WL
fast path (``kernels/weisfeiler_lehman.py``) over a mesh of ranks.

* graphs go to ranks in contiguous blocks of ``ceil(n / P)`` whole
  graphs (edges never straddle ranks, so refinement is local); each
  rank packs its block into a ``GraphBatch`` whose initial label ids
  come from one enumeration of the whole input, the same on every rank;
* each generation, K2 (reach 1) hashes the rank's batch over its CSR,
  the ranks all-gather their int64 keys (every rank's batch is padded
  to one length, derived from the whole input), and one
  ``torch.unique`` on the device (``ops.wl.compact_key_ids``) gives
  every rank the same ids, of which each keeps its slice;
* labels held by one node in the whole input go to the diagonal
  (``ops.wl.split_singletons``, as the single-device path does); the
  rest add the generation's counts Gram as ring-tiled row blocks
  (``parallel.gram``), and one all-gather assembles the full Gram.

Every choice made from data (the count dtype, the chunk plan, the
padded lengths) is made from the whole input, which every rank holds,
so the ranks agree on every shape.  Not ported: ``host_compact`` (the
compaction runs on the device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import GraphBatch, bucket_size, enumerate_labels
from ..ops import wl as wl_ops
from ..ops.gram import chunk_plan, count_dtype
from .gram import _counts_ring
from .mesh import gather_blocks

__all__ = ["distributed_wl_gram"]


def shared_label_enum(graphs):
    """raw vertex label -> id over all ``graphs``, keyed as
    ``GraphBatch.from_graphs`` keys a fresh enumeration (integer labels
    by value, others in order of appearance; unlabeled vertices are 0):
    the same on every rank that holds the same graphs."""
    arrs = [g.numeric_node_label_array() for g in graphs]
    if all(a is not None for a in arrs):
        raw = np.concatenate(arrs) if arrs else np.zeros(0, np.int64)
        return {int(u): i for i, u in enumerate(np.unique(raw))}
    enum = {}
    for g in graphs:
        enumerate_labels([g.node_labels.get(v, 0) for v in range(g.n)],
                         enum)
    return enum


def shard_graphs(graphs, mesh, enum):
    """This rank's contiguous block of ``gpd = ceil(n / P)`` graphs as a
    ``GraphBatch`` on the mesh's device, padded to the node count of the
    largest block (the same on every rank), with its node labels
    renumbered into the shared enumeration ``enum``.  Returns (batch,
    labels int32 [N_pad], gpd, N_pad)."""
    n, P, p = len(graphs), mesh.size, mesh.rank
    gpd = -(-n // P)
    blocks = [graphs[d * gpd:(d + 1) * gpd] for d in range(P)]
    N_pad = bucket_size(max(sum(g.n for g in gs) + 1 for gs in blocks))
    local = {}
    batch = GraphBatch.from_graphs(blocks[p], node_label_enum=local,
                                   node_pad=N_pad, device=mesh.device)
    lut = np.zeros(max(len(local), 1), np.int32)
    for raw, i in local.items():
        lut[i] = enum[raw]
    labels = torch.from_numpy(lut).to(mesh.device)[
        batch.node_labels.to(torch.int64)]
    return batch, labels.contiguous(), gpd, N_pad


def block_layout(graphs, P, gpd, N_pad, device):
    """(valid bool [P * N_pad], global graph ids int64 [P * N_pad]) of
    the gathered node stream, from the whole input: rank d's block fills
    its first nodes, graph by graph; padding nodes get id ``n``."""
    n = len(graphs)
    sizes = np.array([g.n for g in graphs], np.int64)
    valid = np.zeros((P, N_pad), bool)
    gids = np.full((P, N_pad), n, np.int64)
    for d in range(P):
        s = sizes[d * gpd:(d + 1) * gpd]
        m = int(s.sum())
        valid[d, :m] = True
        gids[d, :m] = np.repeat(np.arange(d * gpd, d * gpd + len(s)), s)
    return (torch.from_numpy(valid.ravel()).to(device),
            torch.from_numpy(gids.ravel()).to(device))


def distributed_wl_gram(graphs, n_iter, mesh, axis="g"):
    """Symmetric WL h=``n_iter`` subtree Gram over a mesh of ranks.

    ``graphs``: the same list of :class:`grakel_torch.graph.Graph` (or
    GraKeL-style input) on every rank.  Returns the full [n, n] numpy
    Gram on every rank (padding rows stripped), equal to
    ``WeisfeilerLehman(n_iter=n_iter).fit_transform(graphs)`` bit for bit:
    f32, or f64 when an entry could pass 2^24."""
    from ..kernels.base import normalize_input
    graphs = normalize_input(graphs)
    n, P, p = len(graphs), mesh.size, mesh.rank
    enum = shared_label_enum(graphs)
    batch, labels, gpd, N_pad = shard_graphs(graphs, mesh, enum)
    all_valid, all_gids = block_layout(graphs, P, gpd, N_pad, mesh.device)
    mine = slice(p * N_pad, (p + 1) * N_pad)
    dt = count_dtype((n_iter + 1) * max(g.n for g in graphs) ** 2)
    gids = batch.node_graph_ids.to(torch.int64)
    valid = batch.node_mask
    ones = torch.ones(N_pad, dtype=torch.float32, device=mesh.device)
    K = torch.zeros((gpd, P * gpd), dtype=dt, device=mesh.device)
    diag = torch.zeros(n, dtype=torch.float64, device=mesh.device)
    L = max(len(enum), 1)
    gram_labels, gram_valid = labels, valid
    for it in range(n_iter + 1):
        _counts_ring(mesh, (gids, gram_labels.to(torch.int64), ones,
                            gram_valid), None, gpd, gpd, *chunk_plan(L), K)
        if it == n_iter:
            break
        key = wl_ops._wl_hash_refine_csr(labels, batch.csr_offsets,
                                         batch.csr_targets)
        ids, _, counts = wl_ops.compact_key_ids(gather_blocks(mesh, key),
                                                all_valid)
        gl, gv, n_rep, dc = wl_ops.split_singletons(ids, counts, all_valid,
                                                    all_gids, n)
        diag += dc
        labels, gram_labels, gram_valid = ids[mine], gl[mine], gv[mine]
        L = bucket_size(max(n_rep, 1))
    K = gather_blocks(mesh, K)[:n, :n]
    torch.diagonal(K).add_(diag.to(K.dtype))
    return K.cpu().numpy()
