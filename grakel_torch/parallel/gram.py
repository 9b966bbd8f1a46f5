"""Sharded Gram assembly: ring-tiled Phi @ Phi^T over a mesh of ranks.

The counterpart of ``grakel_tpu/parallel/gram.py``.  Each rank owns a
contiguous row block of graphs.  Feature blocks pass round a ring
(rank p sends to p - 1 and receives from p + 1): at step t a rank holds
the block of rank ``src = (p + t) mod P``, and while the next hop runs
(``dist.batch_isend_irecv`` into a second buffer) it multiplies its own
rows by the visiting block into column block ``src`` of its row block
(``addmm_``, TF32 off).  So no rank ever holds the whole feature
matrix, and each step overlaps one GEMM with one hop.  With P = 1 there
is no hop.

The JAX package is single-controller and returns a row-sharded array;
the port runs one process a rank, every rank called with the full
input, and returns the FULL Gram on every rank, assembled from the row
blocks by one ``all_gather_into_tensor`` (``mesh.gather_blocks``): a
tensor on the mesh's device, the same values ``np.asarray`` gives of
the JAX result.  ``_ring.hops`` counts the ring's hops.

The histogram features feed this through :func:`counts_gram`: a COO
(graph, label, weight) item stream is split per rank, on the device
from the full stream (:func:`rank_items`, the Gram funnel's route) or
on the host (:func:`shard_batch`, the JAX package's public split, which
:func:`sharded_counts_gram` takes), densified a label chunk at a time
with the port's ``index_add_`` (``ops.gram._densify``), and
ring-multiplied, in
the caller's dtype (f64 where ``ops.gram.count_dtype`` says a count
could pass 2^24; the JAX ring is f32 throughout).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gram import _densify, _items, chunk_plan, full_fp32
from .mesh import check_tensor, gather_blocks

__all__ = ["ring_gram", "ring_rect_gram", "sharded_counts_gram",
           "sharded_counts_gram_rect", "shard_batch", "rank_items",
           "counts_gram", "counts_gram_rect"]


def _block(mesh, x, rows, dtype):
    """This rank's row block ``x[p * rows:(p + 1) * rows]`` as a
    contiguous ``dtype`` tensor on the mesh's device (``x`` numpy, or a
    tensor on the mesh's device type)."""
    p = mesh.rank
    if isinstance(x, torch.Tensor):
        check_tensor(mesh, x)
        return x[p * rows:(p + 1) * rows].to(mesh.device, dtype).contiguous()
    return torch.as_tensor(np.asarray(x)[p * rows:(p + 1) * rows],
                           dtype=dtype, device=mesh.device).contiguous()


def _ring(mesh, own, blk, K, col):
    """One pass of the ring: ``K[:, src * col:(src + 1) * col] += own @
    visiting.T`` for every rank's block, starting from this rank's
    ``blk``.  Each step starts the hop of the visiting block to rank p -
    1 (and the receive from p + 1) before its product, and waits for it
    after."""
    P, p = mesh.size, mesh.rank
    buf = None
    if P > 1:
        # the hops write into both buffers: the ring passes its own copy,
        # never ``own`` or the caller's memory (a block may view it)
        blk = blk.clone()
        buf = torch.empty_like(blk)
    with full_fp32():
        for t in range(P):
            reqs = None
            if t < P - 1:
                _ring.hops += 1
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, blk, mesh.global_rank(p - 1),
                               mesh.group),
                    dist.P2POp(dist.irecv, buf, mesh.global_rank(p + 1),
                               mesh.group)])
            src = (p + t) % P
            K[:, src * col:(src + 1) * col].addmm_(own, blk.T)
            if reqs is not None:
                for r in reqs:
                    r.wait()
                blk, buf = buf, blk
    return K


_ring.hops = 0


def _rows_per_rank(n, P, what):
    if n % P:
        raise ValueError("%s: %d rows do not divide over %d ranks (pad "
                         "them)" % (what, n, P))
    return n // P


def ring_gram(mesh, phi, axis_name="g", dtype=torch.float32):
    """K = Phi @ Phi^T with Phi row-sharded over ``mesh``.

    ``phi``: the full [n_rows, L] features on every rank (numpy, or a
    tensor on the mesh's device type), n_rows divisible by the mesh
    size.  Returns the full [n_rows, n_rows] ``dtype`` Gram on the
    mesh's device, on every rank."""
    rows = _rows_per_rank(phi.shape[0], mesh.size, "ring_gram")
    own = _block(mesh, phi, rows, dtype)
    K = torch.zeros((rows, mesh.size * rows), dtype=dtype,
                    device=mesh.device)
    return gather_blocks(mesh, _ring(mesh, own, own, K, rows))


def ring_rect_gram(mesh, phi_rows, phi_cols, axis_name="g",
                   dtype=torch.float32):
    """K[i, j] = <phi_rows[i], phi_cols[j]> with both operands
    row-sharded over ``mesh`` (the transform layout: rows = transform
    graphs, columns = fit graphs; the column blocks pass round the
    ring).  Row counts must divide by the mesh size.  Returns the full
    rectangular ``dtype`` Gram on the mesh's device, on every rank."""
    ry = _rows_per_rank(phi_rows.shape[0], mesh.size, "ring_rect_gram")
    rc = _rows_per_rank(phi_cols.shape[0], mesh.size, "ring_rect_gram")
    own = _block(mesh, phi_rows, ry, dtype)
    blk = _block(mesh, phi_cols, rc, dtype)
    K = torch.zeros((ry, mesh.size * rc), dtype=dtype, device=mesh.device)
    return gather_blocks(mesh, _ring(mesh, own, blk, K, rc))


def shard_batch(gids, labels, weights, valid, n_graphs, n_devices):
    """Host-side split of a COO item stream into per-rank slices (a numpy
    copy of the JAX package's ``shard_batch``).

    Graphs are assigned to ranks in contiguous blocks of ``rows =
    ceil(n_graphs / n_devices)``; every rank gets the same (padded,
    a multiple of 128) number of items.  Returns ``(local_gids [P, I],
    labels [P, I], weights [P, I], valid [P, I], rows_per_device)``
    where ``local_gids`` are row indices within the rank's block.
    Weights are f32, as in the JAX package, unless given in f64 (a
    weight past 2^24 stays exact for an f64 Gram)."""
    gids = np.asarray(gids)
    labels = np.asarray(labels)
    weights = np.asarray(weights)
    valid = np.asarray(valid)
    rows = -(-int(n_graphs) // n_devices)
    dev_of = np.where(valid, gids // rows, 0)
    counts = np.bincount(dev_of[valid], minlength=n_devices)
    I = max(int(counts.max()) if counts.size else 1, 1)
    I = -(-I // 128) * 128
    wt = np.float64 if weights.dtype == np.float64 else np.float32
    lg = np.zeros((n_devices, I), np.int32)
    lb = np.zeros((n_devices, I), labels.dtype)
    lw = np.zeros((n_devices, I), wt)
    lv = np.zeros((n_devices, I), bool)
    idx = np.nonzero(valid)[0]
    if idx.size:
        # stable-sort by rank; an item's slot is its running index less
        # its rank's start
        d = dev_of[idx]
        order = np.argsort(d, kind="stable")
        sel = idx[order]
        dsort = d[order]
        starts = np.zeros(n_devices, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        slot = np.arange(sel.size) - starts[dsort]
        lg[dsort, slot] = (gids[sel] - dsort * rows).astype(np.int32)
        lb[dsort, slot] = labels[sel]
        lw[dsort, slot] = weights[sel]
        lv[dsort, slot] = True
    return lg, lb, lw, lv, rows


def _local_items(mesh, lgids, labels, weights, valid):
    """This rank's slice of :func:`shard_batch`'s [P, I] arrays, as the
    (int64 gids, int64 labels, weights, bool valid) tensors that
    ``ops.gram._densify`` takes, on the mesh's device."""
    p, dev = mesh.rank, mesh.device

    def row(a, dtype=None):
        if isinstance(a, torch.Tensor):
            check_tensor(mesh, a)
            r = a[p]
        else:
            r = torch.from_numpy(np.ascontiguousarray(np.asarray(a)[p]))
        return r.to(dev) if dtype is None else r.to(dev, dtype)

    w = row(weights)
    w = w.to(torch.float64 if w.dtype == torch.float64 else torch.float32)
    return (row(lgids, torch.int64), row(labels, torch.int64), w,
            row(valid, torch.bool))


def rank_items(mesh, gids, labels, weights, valid, n_graphs):
    """This rank's share of a COO item stream that every rank holds in
    full, split on the mesh's device (no copy to the host): the items
    of graphs ``[p * rows, (p + 1) * rows)``, ``rows = ceil(n_graphs /
    P)`` as in :func:`shard_batch`, with block-local graph ids, and every
    other item invalid.  Returns ((gids, labels, weights, valid), rows)
    in the form ``ops.gram._densify`` takes."""
    if isinstance(gids, torch.Tensor):
        check_tensor(mesh, gids)
    n = int(n_graphs)
    g, lab, w, v = _items(torch.as_tensor(gids, device=mesh.device), labels,
                          weights, valid, n)
    rows = -(-n // mesh.size)
    lo = mesh.rank * rows
    return (g - lo, lab, w, v & (g >= lo) & (g < lo + rows)), rows


def _counts_ring(mesh, own_items, blk_items, rows_own, rows_blk, n_chunks,
                 chunk, K):
    """Chunked, ring-accumulated counts Gram: for each label chunk,
    densify this rank's [rows, chunk] blocks and pass the column side's
    round the ring, adding one product a hop (so a wide label universe
    never materializes [rows, L]).  ``blk_items`` None: symmetric."""
    for c in range(n_chunks):
        lo = c * chunk
        own = _densify(*own_items, rows_own, lo, chunk, K.dtype)
        blk = own if blk_items is None else _densify(
            *blk_items, rows_blk, lo, chunk, K.dtype)
        _ring(mesh, own, blk, K, rows_blk)
    return K


def counts_gram(mesh, items, rows, n_labels, chunk=4096,
                dtype=torch.float32):
    """The full [P * rows, P * rows] ``dtype`` counts Gram on every rank
    from this rank's items (block-local graph ids, ``_densify``'s form:
    :func:`rank_items`, or a row of :func:`shard_batch`'s arrays)."""
    nc, ch = chunk_plan(n_labels, chunk)
    K = torch.zeros((rows, mesh.size * rows), dtype=dtype,
                    device=mesh.device)
    return gather_blocks(mesh, _counts_ring(mesh, items, None, rows, rows,
                                           nc, ch, K))


def counts_gram_rect(mesh, y_items, x_items, rows_y, rows_x, n_labels,
                     chunk=4096, dtype=torch.float32):
    """The full [P * rows_y, P * rows_x] rectangular counts Gram on every
    rank from this rank's Y and X items (as in :func:`counts_gram`); the
    X chunk blocks pass round the ring."""
    nc, ch = chunk_plan(n_labels, chunk)
    K = torch.zeros((rows_y, mesh.size * rows_x), dtype=dtype,
                    device=mesh.device)
    return gather_blocks(mesh, _counts_ring(mesh, y_items, x_items, rows_y,
                                           rows_x, nc, ch, K))


def sharded_counts_gram(mesh, lgids, labels, weights, valid, rows, n_labels,
                        axis_name="g", chunk=4096, dtype=torch.float32):
    """Distributed histogram Gram from per-rank COO slices (outputs of
    :func:`shard_batch`, the full [P, I] arrays on every rank).

    Labels stream in chunks (``ops.gram.chunk_plan``, from ``n_labels``:
    the same on every rank), so a rank's working set is [rows, chunk]
    however wide the label universe.  Returns the full [P * rows, P *
    rows] ``dtype`` Gram on the mesh's device, on every rank (rows past
    ``n_graphs`` are zero)."""
    return counts_gram(mesh, _local_items(mesh, lgids, labels, weights,
                                          valid), rows, n_labels, chunk,
                       dtype)


def sharded_counts_gram_rect(mesh, y_items, x_items, rows_y, rows_x,
                             n_labels, axis_name="g", chunk=4096,
                             dtype=torch.float32):
    """Distributed rectangular counts Gram (the transform block): rows =
    Y graphs, columns = X (fit) graphs, both COO streams split by
    :func:`shard_batch`; ``y_items`` / ``x_items`` are the (lgids,
    labels, weights, valid) quadruples.  The X chunk blocks pass round
    the ring.  Returns the full [P * rows_y, P * rows_x] ``dtype`` Gram
    on the mesh's device, on every rank."""
    return counts_gram_rect(mesh, _local_items(mesh, *y_items),
                            _local_items(mesh, *x_items), rows_y, rows_x,
                            n_labels, chunk, dtype)
