"""Gram-matrix assembly ops on tensors.

The counterpart of ``grakel_tpu/ops/gram.py``.  Every feature-map kernel
reduces to "feature extraction -> Phi @ Phi^T".  The histogram kernels
never materialize a dense [n_graphs, n_labels] matrix when the label
universe is large: :func:`coo_counts_gram` streams label chunks through
a scatter (``index_add_``) -> GEMM-accumulate loop on the tensors'
device.

:func:`sparse_counts_gram` is the one host function: a multiplicity-split
Gram in numpy for count matrices too sparse and wide for the chunked
GEMM (its dense block of the most-shared columns multiplied on the
caller's device, or the host).  :func:`split_weighted_singletons` splits
a weighted count matrix's singleton columns into the diagonal, and
:func:`shared_cols_gram_rect` restricts a rectangular Gram to the
columns both sides hold.  :func:`normalize_gram` normalizes a Gram in
float64 where it lies: a CUDA tensor on its card by K17
(:func:`normalize_gram_cuda`), anything else in numpy on the host.

While a mesh is installed (:func:`use_mesh`), :func:`gram_gemm`,
:func:`gram_rect`, :func:`coo_counts_gram` and
:func:`coo_counts_gram_rect` reroute to the ring-sharded programs of
:mod:`grakel_torch.parallel` (every rank of the mesh calls them with
the same full input and gets the full Gram).

Every GEMM here runs in full fp32 (TF32 off, set and restored around
each product): count Grams hold exact integers below 2^24 only in full
fp32, and TF32 keeps ~10 mantissa bits.  The counts-Gram functions take
``dtype=torch.float64`` from a caller whose entries can pass 2^24 (f64
sums of integers are exact below 2^53).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..profiling import host_span

__all__ = ["gram_gemm", "gram_rect", "normalize_gram",
           "normalize_gram_cuda", "coo_counts_gram", "coo_counts_gram_rect",
           "counts_diag", "chunked_counts_gram_raw", "chunk_plan", "full_fp32",
           "sparse_counts_gram", "count_dtype", "split_weighted_singletons",
           "shared_cols_gram_rect", "use_mesh", "active_mesh"]


# --------------------------------------------------------------------- #
# active mesh: the counts- and feature-GEMMs below reroute through the
# ring-sharded programs in grakel_torch.parallel while one is installed.
# The base Kernel installs ``self.mesh`` around its entry points, so
# every kernel that funnels its Gram through these functions runs over
# the mesh without kernel-specific wiring.
# --------------------------------------------------------------------- #

_MESH = None


class _MeshCtx:
    def __init__(self, mesh, prev):
        self.mesh = mesh
        self.prev = prev

    def __enter__(self):
        return self.mesh

    def __exit__(self, *exc):
        global _MESH
        _MESH = self.prev
        return False


def use_mesh(mesh):
    """Context manager: route eligible Gram assembly over ``mesh`` (a
    :class:`grakel_torch.parallel.Mesh`; None and meshes of one rank are
    no-ops).  Plain module state, deliberately not thread-local (as
    :func:`grakel_torch.device.use_device`): framework base kernels
    dispatched on worker threads inherit the outer kernel's mesh."""
    global _MESH
    ctx = _MeshCtx(mesh, _MESH)
    _MESH = mesh if (mesh is not None and mesh.size > 1) else None
    return ctx


def active_mesh():
    """The mesh installed by :func:`use_mesh`, or None."""
    return _MESH


def _pad_rows(a, rows):
    """``a`` [n, L] padded with zero rows to ``rows``."""
    return torch.nn.functional.pad(a, (0, 0, 0, rows - a.shape[0]))


def count_dtype(bound):
    """The dtype of a count Gram whose entries (and so every partial sum
    of nonnegative integer products) are at most ``bound``: f32 sums of
    integers are exact below 2^24, f64 ones below 2^53.  The callers
    bound their entries on the host, so the choice costs no device
    read."""
    return torch.float32 if bound < 1 << 24 else torch.float64


@contextlib.contextmanager
def full_fp32():
    """Full-fp32 matrix products for the block, whatever the ambient
    TF32 setting; restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mm_t(a, b):
    """a @ b.T in full fp32."""
    with full_fp32():
        return a @ b.T


def _as_features(x, device, dtype=torch.float32):
    if hasattr(x, "toarray"):  # scipy sparse
        x = x.toarray()
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _needs_f64(x):
    """float64 numpy feature matrices keep full precision through a host
    GEMM (the narrow f64 feature kernels of the JAX package; counts stay
    f32 on the device)."""
    return (isinstance(x, np.ndarray) and x.dtype == np.float64
            and x.size > 0)


def gram_gemm(phi, device=None, dtype=torch.float32):
    """K = Phi @ Phi^T (symmetric Gram) on ``device`` (None: the ambient
    device, else cuda) in ``dtype`` (a count Gram passes
    :func:`count_dtype` of its bound); a float64 numpy ``phi`` stays a
    host f64 product."""
    if _needs_f64(phi):
        return torch.from_numpy(phi @ phi.T)
    a = _as_features(phi, resolve_device(device), dtype)
    mesh = active_mesh()
    if mesh is not None:
        from ..parallel.gram import ring_gram
        n, P = a.shape[0], mesh.size
        K = ring_gram(mesh, _pad_rows(a, P * -(-n // P)), dtype=dtype)
        return K[:n, :n]
    return _mm_t(a, a)


def gram_rect(phi_rows, phi_cols, device=None, dtype=torch.float32):
    """K[i, j] = <phi_rows[i], phi_cols[j]> in ``dtype``, truncating or
    padding the row features to the column feature width (transform
    semantics: columns = fit graphs; features unseen at fit contribute
    nothing)."""
    if _needs_f64(phi_rows) or _needs_f64(phi_cols):
        def dense64(x):
            if hasattr(x, "toarray"):
                x = x.toarray()
            return np.asarray(x, np.float64)
        a = dense64(phi_rows)
        b = dense64(phi_cols)
        d = b.shape[1]
        if a.shape[1] > d:
            a = a[:, :d]
        elif a.shape[1] < d:
            a = np.pad(a, ((0, 0), (0, d - a.shape[1])))
        return torch.from_numpy(a @ b.T)
    device = resolve_device(device)
    a = _as_features(phi_rows, device, dtype)
    b = _as_features(phi_cols, device, dtype)
    d = b.shape[1]
    if a.shape[1] > d:
        a = a[:, :d]
    elif a.shape[1] < d:
        a = torch.nn.functional.pad(a, (0, d - a.shape[1]))
    mesh = active_mesh()
    if mesh is not None:
        from ..parallel.gram import ring_rect_gram
        ny, nx, P = a.shape[0], b.shape[0], mesh.size
        K = ring_rect_gram(mesh, _pad_rows(a, P * -(-ny // P)),
                           _pad_rows(b, P * -(-nx // P)), dtype=dtype)
        return K[:ny, :nx]
    return _mm_t(a, b)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def normalize_gram(K, diag_rows, diag_cols):
    """K / sqrt(outer(diag_rows, diag_cols)) in float64, with numpy's
    ``nan_to_num`` after it: 0/0 maps to 0 and x/0 to the largest double
    of x's sign (the Gram's last step before it is returned).

    The route follows K.  A CUDA tensor is normalized on its card by K17
    (:func:`normalize_gram_cuda`, the diagonals moved there as f64) and
    comes back as an f64 CUDA tensor; no host span is opened around the
    launch.  A numpy array or a CPU tensor is normalized in float64 numpy
    on the host inside the host span ``normalize`` and comes back as a
    numpy array.  Both give numpy's bits: numpy's sqrt and division are
    correctly rounded and so are K17's ``__dsqrt_rn`` / ``__ddiv_rn``,
    while the CPU build of torch's sqrt is not; the JAX package
    normalizes in numpy."""
    if isinstance(K, torch.Tensor) and K.is_cuda:
        if not (K.is_contiguous() and K.data_ptr() % 16 == 0):
            K = K.clone(memory_format=torch.contiguous_format)
        return normalize_gram_cuda(K, _f64_on(diag_rows, K.device),
                                   _f64_on(diag_cols, K.device))
    K, dr, dc = _host(K), _host(diag_rows), _host(diag_cols)
    with host_span("normalize"):
        K = np.asarray(K, dtype=np.float64)
        dr = np.asarray(dr, dtype=np.float64)
        dc = np.asarray(dc, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = K / np.sqrt(np.outer(dr, dc))
        return np.nan_to_num(out)


def _f64_on(d, device):
    """A diagonal (numpy or tensor) as a contiguous f64 tensor on
    ``device``."""
    return torch.as_tensor(d, dtype=torch.float64,
                           device=device).contiguous()


def normalize_gram_cuda(K, dr, dc):
    """Launch K17 (``csrc/gram_norm.cu``): ``out = K / sqrt(dr_i dc_j)``
    with numpy's ``nan_to_num`` mapping, bit-equal to the host route of
    :func:`normalize_gram`.  K: a contiguous, 16-byte aligned f32 or f64
    CUDA tensor [m, n]; dr [m], dc [n]: contiguous f64 on K's device.
    Returns a fresh f64 [m, n] on the current stream, with no
    synchronization (one launch; none when K is empty)."""
    from .. import _build
    dev = K.device
    ok = (dev.type == "cuda" and K.dim() == 2
          and K.dtype in (torch.float32, torch.float64)
          and K.is_contiguous() and K.data_ptr() % 16 == 0
          and max(K.shape) < 1 << 31)
    if ok:
        m, n = K.shape
        ok = all(d.device == dev and d.dtype == torch.float64
                 and d.is_contiguous() and d.shape == (size,)
                 for d, size in ((dr, m), (dc, n)))
    if not ok:
        raise ValueError("normalize_gram_cuda: need a contiguous, 16-byte "
                         "aligned f32 or f64 CUDA tensor K [m, n] and "
                         "contiguous f64 diagonals [m], [n] on its device")
    out = torch.empty((m, n), dtype=torch.float64, device=dev)
    if m and n:
        _build.launch("grakel_normalize_gram", dev, K.data_ptr(),
                      int(K.dtype == torch.float64), dr.data_ptr(),
                      dc.data_ptr(), out.data_ptr(), m, n)
        normalize_gram_cuda.launches += 1
    return out


normalize_gram_cuda.launches = 0


# --------------------------------------------------------------------- #
# chunked COO-count Gram: K[g, g'] = sum_l c[g, l] * c[g', l]
# --------------------------------------------------------------------- #

def _densify(gids, labels, weights, valid, n, lo, chunk,
             dtype=torch.float32):
    """counts[g, l - lo] for the items with lo <= l < lo + chunk, as a
    [n, chunk] ``dtype`` tensor (scatter by index_add_)."""
    rel = labels - lo
    in_chunk = valid & (rel >= 0) & (rel < chunk)
    seg = gids[in_chunk] * chunk + rel[in_chunk]
    counts = torch.zeros(n * chunk, dtype=dtype, device=gids.device)
    counts.index_add_(0, seg, weights[in_chunk].to(dtype))
    return counts.view(n, chunk)


def _items(gids, labels, weights, valid, n):
    """Items as (int64 gids, int64 labels, weights, bool valid) on gids'
    device, with out-of-range graph ids invalid.  Weights stay f64 when
    given in f64 (a weight past 2^24 stays exact for an f64 Gram), else
    become f32."""
    dev = gids.device
    g = gids.to(torch.int64)
    lab = torch.as_tensor(labels, device=dev).to(torch.int64)
    w = torch.as_tensor(weights, device=dev)
    w = w.to(torch.float64 if w.dtype == torch.float64 else torch.float32)
    v = torch.as_tensor(valid, device=dev).to(torch.bool) \
        & (g >= 0) & (g < n)
    return g, lab, w, v


def chunked_counts_gram_raw(gids, labels, weights, valid, n_graphs,
                            n_chunks, chunk, K0=None, dtype=torch.float32):
    """Symmetric counts-Gram accumulation over ``n_chunks`` label chunks
    of width ``chunk``: each chunk densifies counts to [n_graphs, chunk]
    and accumulates one GEMM in ``dtype``.  Items with valid=False or a
    label outside every chunk contribute nothing.  ``K0`` is the
    starting accumulator (updated in place, in its own dtype; zeros of
    ``dtype`` if None)."""
    n = int(n_graphs)
    g, lab, w, v = _items(gids, labels, weights, valid, n)
    K = torch.zeros((n, n), dtype=dtype, device=g.device) \
        if K0 is None else K0
    with full_fp32():
        for c in range(n_chunks):
            C = _densify(g, lab, w, v, n, c * chunk, chunk, K.dtype)
            K.addmm_(C, C.T)
    return K


def _chunks_for(n_labels, chunk):
    return max(1, -(-int(n_labels) // chunk))


def chunk_plan(n_labels, chunk=4096):
    """(n_chunks, chunk_width) used by the chunked counts-Grams."""
    chunk = min(chunk, max(128, 1 << (int(n_labels) - 1).bit_length()))
    return _chunks_for(n_labels, chunk), chunk


def _mesh_counts_gram(mesh, gids, labels, weights, valid, n_graphs,
                      n_labels, chunk, dtype):
    """:func:`coo_counts_gram` over ``mesh``: each rank takes its graphs'
    items from the full stream on the device, densifies them and
    ring-multiplies them (``parallel.gram.counts_gram``)."""
    from ..parallel.gram import counts_gram, rank_items
    n = int(n_graphs)
    items, rows = rank_items(mesh, gids, labels, weights, valid, n)
    return counts_gram(mesh, items, rows, int(n_labels), chunk, dtype)[:n, :n]


def _mesh_counts_gram_rect(mesh, ga, la, wa, va, gb, lb, wb, vb, n_a, n_b,
                           n_labels, chunk, dtype):
    from ..parallel.gram import counts_gram_rect, rank_items
    n_a, n_b = int(n_a), int(n_b)
    ya, rows_a = rank_items(mesh, ga, la, wa, va, n_a)
    xb, rows_b = rank_items(mesh, gb, lb, wb, vb, n_b)
    K = counts_gram_rect(mesh, ya, xb, rows_a, rows_b, int(n_labels), chunk,
                         dtype)
    return K[:n_a, :n_b]


def coo_counts_gram(gids, labels, weights, valid, n_graphs, n_labels,
                    chunk=4096, dtype=torch.float32):
    """K[g,g'] = sum_l (sum_{i: gid=g, lab=l} w_i) * (same for g').

    Item arrays are tensors on one device (``labels``, ``weights`` and
    ``valid`` may also be numpy; they follow ``gids``' device).  Returns
    a ``dtype`` [n_graphs, n_graphs] tensor there.  Under an active
    :func:`use_mesh` mesh the Gram assembles as ring-tiled row blocks
    across its ranks, on the mesh's device."""
    mesh = active_mesh()
    if mesh is not None:
        return _mesh_counts_gram(mesh, gids, labels, weights, valid,
                                 n_graphs, n_labels, chunk, dtype)
    nc, ch = chunk_plan(n_labels, chunk)
    return chunked_counts_gram_raw(gids, labels, weights, valid,
                                   n_graphs, nc, ch, dtype=dtype)


def coo_counts_gram_rect(ga, la, wa, va, gb, lb, wb, vb,
                         n_a, n_b, n_labels, chunk=4096,
                         dtype=torch.float32):
    """K[i, j] = <counts_a[i], counts_b[j]> over a label universe of
    ``n_labels``; ``dtype`` [n_a, n_b] on ``ga``'s device (on the
    mesh's, ring-tiled, under an active :func:`use_mesh` mesh)."""
    mesh = active_mesh()
    if mesh is not None:
        return _mesh_counts_gram_rect(mesh, ga, la, wa, va, gb, lb, wb, vb,
                                      n_a, n_b, n_labels, chunk, dtype)
    n_a, n_b = int(n_a), int(n_b)
    nc, ch = chunk_plan(n_labels, chunk)
    a = _items(ga, la, wa, va, n_a)
    b = _items(gb.to(ga.device), lb, wb, vb, n_b)
    K = torch.zeros((n_a, n_b), dtype=dtype, device=ga.device)
    with full_fp32():
        for c in range(nc):
            ca = _densify(*a, n_a, c * ch, ch, dtype)
            cb = _densify(*b, n_b, c * ch, ch, dtype)
            K.addmm_(ca, cb.T)
    return K


def shared_cols_gram_rect(ga, ca, wa, gb, cb, wb, n_a, n_b, device,
                          chunk=4096, dtype=torch.float32):
    """K[i, j] = sum_l a[i, l] b[j, l] over numpy items ``(graph,
    column, weight)`` of each side, multiplied only over the columns
    both sides hold (any other column adds zero to every entry),
    renumbered densely in column order: the rectangular counts-Gram on
    ``device``, a ``dtype`` [n_a, n_b] tensor there.  Weights keep their
    width as in :func:`coo_counts_gram_rect` (f64 stays f64)."""
    keys = np.unique(ca[np.isin(ca, cb)])
    ha, hb = np.isin(ca, keys), np.isin(cb, keys)

    def side(g, c, w, hit):
        return (torch.from_numpy(np.asarray(g[hit], np.int64)).to(device),
                np.searchsorted(keys, c[hit]), w[hit], True)

    return coo_counts_gram_rect(*side(ga, ca, wa, ha), *side(gb, cb, wb, hb),
                                n_a, n_b, max(len(keys), 1), chunk=chunk,
                                dtype=dtype)


def counts_diag(gids, labels, weights, valid, n_graphs, n_labels,
                chunk=4096, dtype=torch.float32):
    """diag of coo_counts_gram without forming K; ``dtype`` [n_graphs]."""
    n = int(n_graphs)
    nc, ch = chunk_plan(n_labels, chunk)
    items = _items(gids, labels, weights, valid, n)
    d = torch.zeros(n, dtype=dtype, device=gids.device)
    for c in range(nc):
        C = _densify(*items, n, c * ch, ch, dtype)
        d += (C * C).sum(1)
    return d


def split_weighted_singletons(gids, cols, weights, n_graphs,
                              col_weights=None):
    """Split a weighted count matrix ``c[g, l]`` (items ``(gids, cols,
    weights)``, numpy; duplicate (graph, column) items sum) for the Gram
    ``K[i, j] = sum_l s_l c[i, l] c[j, l]`` (``s = col_weights``, default
    1): a column that one (graph, column) item holds after the sum adds
    only ``s_l c^2`` to that graph's diagonal; every other column is
    renumbered densely, in column order.

    The weighted form of ``ops.wl.split_singletons`` (whose diagonal
    correction counts unit items).  Returns ``(g, l, w, shared_cols,
    diag)``: the shared columns' items (int64 graph ids, int64 dense
    column ids, summed weights), ``shared_cols`` the original id of each
    dense column, and ``diag[n_graphs]`` the singletons' part of the
    diagonal (int64 for integer weights, so exact; else float64)."""
    gids = np.asarray(_host(gids), np.int64)
    cols = np.asarray(_host(cols), np.int64)
    w = np.asarray(_host(weights))
    s = None if col_weights is None else np.asarray(_host(col_weights))
    acc = np.result_type(w, np.int64 if s is None else s)
    acc = np.int64 if acc.kind in "biu" else np.float64
    n = int(n_graphs)
    if gids.size == 0:
        e = np.zeros(0, np.int64)
        return e, e, np.zeros(0, acc), e, np.zeros(n, acc)
    uk, inv = np.unique(cols * n + gids, return_inverse=True)
    ws = np.zeros(len(uk), acc)
    np.add.at(ws, inv.reshape(-1), w.astype(acc))
    c, g = uk // n, uk % n
    new_col = c[1:] != c[:-1]
    single = np.r_[True, new_col] & np.r_[new_col, True]
    sq = ws[single] * ws[single]
    if s is not None:
        sq = sq * s[c[single]].astype(acc)
    diag = np.zeros(n, acc)
    np.add.at(diag, g[single], sq)
    keep = ~single
    shared_cols, dense = np.unique(c[keep], return_inverse=True)
    return g[keep], dense.reshape(-1), ws[keep], shared_cols, diag


def sparse_counts_gram(gids, labels, n_graphs, weights=None,
                       dense_col_mult=64, dtype=torch.float32,
                       device=None):
    """K[g, g'] = sum_l c[g, l] c[g', l] assembled on the host for very
    sparse, very wide count matrices (late WL-SP generations mint
    millions of mostly-singleton triplet columns, where a chunked GEMM
    over every column is nearly all zeros).

    The multiplicity-split scheme of ``grakel_tpu/ops/gram.py``, after
    one label-major sort:

    * columns touching <= ``dense_col_mult`` graphs contribute their
      in-column pair products through one global bincount scatter
      (cost = sum over those columns of nnz_col^2);
    * denser columns gather into one [n, n_hot] block, multiplied in
      ``dtype``'s width (f32: exact for integer sums below 2^24; f64
      below 2^53) on ``device``.

    ``gids`` / ``labels`` are per-item numpy arrays (or tensors, read to
    the host); duplicates are allowed and their weights (default 1) sum.
    ``device`` (None: the host) is where the dense block is
    multiplied.  Returns float64 numpy [n, n]."""
    gids = np.asarray(_host(gids), np.int64)
    labels = np.asarray(_host(labels), np.int64)
    n = int(n_graphs)
    K = np.zeros((n, n))
    if gids.size == 0:
        return K
    w = (np.ones(gids.size) if weights is None
         else np.asarray(_host(weights), np.float64))
    key = labels * n + gids
    uk, inv = np.unique(key, return_inverse=True)
    cw = np.bincount(inv, weights=w)
    cols = uk // n
    rows = uk % n
    starts = np.flatnonzero(np.r_[True, cols[1:] != cols[:-1]])
    sizes = np.diff(np.r_[starts, len(cols)])
    singles = sizes == 1
    if singles.any():
        r1 = rows[starts[singles]]
        np.add.at(K, (r1, r1), cw[starts[singles]] ** 2)
    pair_idx, pair_w, pending = [], [], 0
    for s in np.unique(sizes):
        if s < 2 or s > dense_col_mult:
            continue
        gs = starts[sizes == s]
        idx = gs[:, None] + np.arange(s)
        R = rows[idx]
        W = cw[idx]
        flat = (R[:, :, None] * n + R[:, None, :]).ravel()
        pw = (W[:, :, None] * W[:, None, :]).ravel()
        pair_idx.append(flat)
        pair_w.append(pw)
        pending += flat.size
        if pending > 20_000_000:   # bound temporaries across groups
            K += np.bincount(np.concatenate(pair_idx),
                             weights=np.concatenate(pair_w),
                             minlength=n * n).reshape(n, n)
            pair_idx, pair_w, pending = [], [], 0
    if pair_idx:
        K += np.bincount(np.concatenate(pair_idx),
                         weights=np.concatenate(pair_w),
                         minlength=n * n).reshape(n, n)
    hot = sizes > dense_col_mult
    if hot.any():
        ent = np.repeat(hot, sizes)
        gcol = np.cumsum(hot) - 1
        K += _hot_gram(rows[ent], np.repeat(gcol[hot], sizes[hot]),
                       cw[ent], n, int(hot.sum()), dtype, device)
    return K


def _hot_gram(r, c, w, n, width, dtype, device):
    """D D^T of the dense block D[r, c] = w, built and multiplied on
    ``device`` (None: the host) in ``dtype`` (TF32 off); f64 numpy."""
    device = torch.device("cpu") if device is None else device
    D = torch.zeros((n, width), dtype=dtype, device=device)
    D[torch.from_numpy(r).to(device), torch.from_numpy(c).to(device)] = \
        torch.from_numpy(w).to(device, dtype)
    with full_fp32():
        return (D @ D.T).to(torch.float64).cpu().numpy()
