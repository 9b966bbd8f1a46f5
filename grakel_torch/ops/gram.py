"""Gram-matrix assembly ops on tensors.

The counterpart of ``grakel_tpu/ops/gram.py``.  Every feature-map kernel
reduces to "feature extraction -> Phi @ Phi^T".  The histogram kernels
never materialize a dense [n_graphs, n_labels] matrix when the label
universe is large: :func:`coo_counts_gram` streams label chunks through
a scatter (``index_add_``) -> GEMM-accumulate loop on the tensors'
device.

Every GEMM here runs in full fp32 (TF32 off, set and restored around
each product): count Grams hold exact integers below 2^24 only in full
fp32, and TF32 keeps ~10 mantissa bits.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["gram_gemm", "gram_rect", "normalize_gram",
           "coo_counts_gram", "coo_counts_gram_rect", "counts_diag",
           "chunked_counts_gram_raw", "chunk_plan", "full_fp32"]


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


def _as_features(x, device):
    if hasattr(x, "toarray"):  # scipy sparse
        x = x.toarray()
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _needs_f64(x):
    """float64 numpy feature matrices keep full precision through a host
    GEMM (the narrow f64 feature kernels of the JAX package; counts stay
    f32 on the device)."""
    return (isinstance(x, np.ndarray) and x.dtype == np.float64
            and x.size > 0)


def gram_gemm(phi, device=None):
    """K = Phi @ Phi^T (symmetric Gram) on ``device`` (None: the ambient
    device, else cuda); a float64 numpy ``phi`` stays a host f64
    product."""
    if _needs_f64(phi):
        return torch.from_numpy(phi @ phi.T)
    a = _as_features(phi, resolve_device(device))
    return _mm_t(a, a)


def gram_rect(phi_rows, phi_cols, device=None):
    """K[i, j] = <phi_rows[i], phi_cols[j]>, truncating/padding the row
    features to the column feature width (transform semantics: columns =
    fit graphs; features unseen at fit contribute nothing)."""
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
    a = _as_features(phi_rows, device)
    b = _as_features(phi_cols, device)
    d = b.shape[1]
    if a.shape[1] > d:
        a = a[:, :d]
    elif a.shape[1] < d:
        a = torch.nn.functional.pad(a, (0, d - a.shape[1]))
    return _mm_t(a, b)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def normalize_gram(K, diag_rows, diag_cols):
    """K / sqrt(outer(diag_rows, diag_cols)) with 0/0 and x/0 mapped to 0,
    as float64 numpy on the host (the Gram's last step before it is
    returned; numpy's sqrt is correctly rounded, the CPU build of
    torch's is not, and the JAX package normalizes in numpy)."""
    K = np.asarray(_host(K), dtype=np.float64)
    dr = np.asarray(_host(diag_rows), dtype=np.float64)
    dc = np.asarray(_host(diag_cols), dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = K / np.sqrt(np.outer(dr, dc))
    return np.nan_to_num(out)


# --------------------------------------------------------------------- #
# chunked COO-count Gram: K[g, g'] = sum_l c[g, l] * c[g', l]
# --------------------------------------------------------------------- #

def _densify(gids, labels, weights, valid, n, lo, chunk):
    """counts[g, l - lo] for the items with lo <= l < lo + chunk, as a
    [n, chunk] f32 tensor (scatter by index_add_)."""
    rel = labels - lo
    in_chunk = valid & (rel >= 0) & (rel < chunk)
    seg = gids[in_chunk] * chunk + rel[in_chunk]
    counts = torch.zeros(n * chunk, dtype=torch.float32, device=gids.device)
    counts.index_add_(0, seg, weights[in_chunk])
    return counts.view(n, chunk)


def _items(gids, labels, weights, valid, n):
    """Items as (int64 gids, int64 labels, f32 weights, bool valid) on
    gids' device, with out-of-range graph ids invalid."""
    dev = gids.device
    g = gids.to(torch.int64)
    lab = torch.as_tensor(labels, device=dev).to(torch.int64)
    w = torch.as_tensor(weights, device=dev).to(torch.float32)
    v = torch.as_tensor(valid, device=dev).to(torch.bool) \
        & (g >= 0) & (g < n)
    return g, lab, w, v


def chunked_counts_gram_raw(gids, labels, weights, valid, n_graphs,
                            n_chunks, chunk, K0=None):
    """Symmetric counts-Gram accumulation over ``n_chunks`` label chunks
    of width ``chunk``: each chunk densifies counts to [n_graphs, chunk]
    and accumulates one GEMM.  Items with valid=False or a label outside
    every chunk contribute nothing.  ``K0`` is the starting accumulator
    (updated in place; zeros if None)."""
    n = int(n_graphs)
    g, lab, w, v = _items(gids, labels, weights, valid, n)
    K = torch.zeros((n, n), dtype=torch.float32, device=g.device) \
        if K0 is None else K0
    with full_fp32():
        for c in range(n_chunks):
            C = _densify(g, lab, w, v, n, c * chunk, chunk)
            K.addmm_(C, C.T)
    return K


def _chunks_for(n_labels, chunk):
    return max(1, -(-int(n_labels) // chunk))


def chunk_plan(n_labels, chunk=4096):
    """(n_chunks, chunk_width) used by the chunked counts-Grams."""
    chunk = min(chunk, max(128, 1 << (int(n_labels) - 1).bit_length()))
    return _chunks_for(n_labels, chunk), chunk


def coo_counts_gram(gids, labels, weights, valid, n_graphs, n_labels,
                    chunk=4096):
    """K[g,g'] = sum_l (sum_{i: gid=g, lab=l} w_i) * (same for g').

    Item arrays are tensors on one device (``labels``, ``weights`` and
    ``valid`` may also be numpy; they follow ``gids``' device).  Returns
    an f32 [n_graphs, n_graphs] tensor there."""
    nc, ch = chunk_plan(n_labels, chunk)
    return chunked_counts_gram_raw(gids, labels, weights, valid,
                                   n_graphs, nc, ch)


def coo_counts_gram_rect(ga, la, wa, va, gb, lb, wb, vb,
                         n_a, n_b, n_labels, chunk=4096):
    """K[i, j] = <counts_a[i], counts_b[j]> over a label universe of
    ``n_labels``; f32 [n_a, n_b] on ``ga``'s device."""
    n_a, n_b = int(n_a), int(n_b)
    nc, ch = chunk_plan(n_labels, chunk)
    a = _items(ga, la, wa, va, n_a)
    b = _items(gb.to(ga.device), lb, wb, vb, n_b)
    K = torch.zeros((n_a, n_b), dtype=torch.float32, device=ga.device)
    with full_fp32():
        for c in range(nc):
            ca = _densify(*a, n_a, c * ch, ch)
            cb = _densify(*b, n_b, c * ch, ch)
            K.addmm_(ca, cb.T)
    return K


def counts_diag(gids, labels, weights, valid, n_graphs, n_labels,
                chunk=4096):
    """diag of coo_counts_gram without forming K; f32 [n_graphs]."""
    n = int(n_graphs)
    nc, ch = chunk_plan(n_labels, chunk)
    items = _items(gids, labels, weights, valid, n)
    d = torch.zeros(n, dtype=torch.float32, device=gids.device)
    for c in range(nc):
        C = _densify(*items, n, c * ch, ch)
        d += (C * C).sum(1)
    return d
