"""Batched top-d |eigenvector| embeddings for PyramidMatch.

The counterpart of ``grakel_tpu/ops/spectral.py``.  The reference runs
one ARPACK ``eigs(A, k=d, ncv=10d)`` per graph: the d eigenpairs of
LARGEST MAGNITUDE, then ordered by descending eigenvalue; the embedding
is the element-wise absolute value, so eigenvector signs are free and a
symmetric solver is exact for the same spectrum.

Graphs are size-bucketed, densified on the device from one COO edge
list, and each slab runs a batched Lanczos with full
reorthogonalization (``bmm`` / ``einsum``) followed by one batched
``torch.linalg.eigh`` of the [S, m, m] tridiagonal:

* zero padding adds eigenvalue-0 pairs, the smallest possible
  MAGNITUDE, and the start vector is masked to the real vertices, so
  the padded coordinates never enter the Krylov space;
* per graph, the d largest-|lambda| Ritz pairs are selected and then
  reordered by descending eigenvalue (ARPACK ``which='LM'`` +
  ``argsort()[::-1]``).

Exact-magnitude ties at the selection boundary are resolved by index
(stable sort), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["batched_topd_abs_eigvecs"]

_SLAB = 128
_SLAB_BYTES = 1 << 28  # cap [S, V, V] f32 slab at 256 MB device bytes
_LANCZOS_M = 64


def _slab_cap(V):
    return int(max(1, min(_SLAB, _SLAB_BYTES // (V * V * 4))))


def _lanczos_topd(A, v0, d):
    """A [S, V, V] symmetric f32, v0 [S, V] -> |U| [S, V, d]."""
    S, V, _ = A.shape
    m = min(_LANCZOS_M, V)
    dev = A.device
    nrm = torch.sqrt((v0 * v0).sum(1, keepdim=True))
    v = v0 * torch.where(nrm > 0, 1.0 / nrm.clamp_min(1e-30),
                         torch.zeros_like(nrm))
    Q = torch.zeros((S, V, m), dtype=torch.float32, device=dev)
    al = torch.zeros((S, m), dtype=torch.float32, device=dev)
    be = torch.zeros((S, m), dtype=torch.float32, device=dev)
    v_prev = torch.zeros((S, V), dtype=torch.float32, device=dev)
    beta_prev = torch.zeros(S, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for j in range(m):
        Q[:, :, j] = v
        w = torch.bmm(A, v[:, :, None])[:, :, 0] \
            - beta_prev[:, None] * v_prev
        aj = (v * w).sum(1)
        w = w - aj[:, None] * v
        # full reorthogonalization against the whole basis; unset
        # columns are zero and contribute nothing
        proj = torch.einsum("svm,sv->sm", Q, w)
        w = w - torch.einsum("svm,sm->sv", Q, proj)
        bj = torch.sqrt((w * w).sum(1))
        ok = bj > 1e-6
        invb = torch.where(ok, 1.0 / bj.clamp_min(1e-30), zero)
        v_prev, v = v, w * invb[:, None]
        bj = torch.where(ok, bj, zero)
        al[:, j] = aj
        be[:, j] = bj
        beta_prev = bj
    r = torch.arange(m, device=dev)
    T = torch.zeros((S, m, m), dtype=torch.float32, device=dev)
    T[:, r, r] = al
    T[:, r[:-1], r[1:]] = be[:, :m - 1]
    T[:, r[1:], r[:-1]] = be[:, :m - 1]
    theta, Y = torch.linalg.eigh(T)                          # [S, m]
    # top-d by |lambda|, then descending lambda among them
    order = torch.argsort(-theta.abs(), dim=1, stable=True)[:, :d]
    lam = torch.gather(theta, 1, order)
    reord = torch.argsort(-lam, dim=1, stable=True)
    sel = torch.gather(order, 1, reord)                      # [S, d]
    Ysel = torch.gather(Y, 2, sel[:, None, :].expand(S, m, sel.shape[1]))
    return torch.einsum("svm,smd->svd", Q, Ysel).abs()


def batched_topd_abs_eigvecs(items, d, device=None):
    """items: list of (key, n, src, dst, w) COO adjacencies (n >= 2).
    Returns {key: |U| [n, d] float64 numpy} via slab-batched Lanczos on
    ``device`` (None: the ambient device, else cuda)."""
    device = resolve_device(device)
    out = {}
    buckets = {}
    for item in items:
        n = int(item[1])
        V = max(8, 1 << (n - 1).bit_length())
        buckets.setdefault(V, []).append(item)
    for V, group in sorted(buckets.items()):
        s_cap = _slab_cap(V)
        for s0 in range(0, len(group), s_cap):
            slab = group[s0:s0 + s_cap]
            S = len(slab)
            flats, ws = [], []
            # deterministic start vector MASKED to real vertices: the
            # Krylov space then lives entirely in the real subspace
            v0 = np.zeros((S, V), np.float32)
            for g, (key, n, i, j, wg) in enumerate(slab):
                v0[g, :n] = np.cos(1.372954 * np.arange(n) + 0.718281 * g)
                flats.append(g * (V * V) + np.asarray(i, np.int64) * V
                             + np.asarray(j, np.int64))
                ws.append(np.asarray(wg, np.float32))
            flat = torch.from_numpy(np.concatenate(flats)).to(device)
            w = torch.from_numpy(np.concatenate(ws)).to(device)
            A = torch.zeros(S * V * V, dtype=torch.float32, device=device)
            A.index_add_(0, flat, w)
            U = _lanczos_topd(A.view(S, V, V),
                              torch.from_numpy(v0).to(device), d)
            U = U.double().cpu().numpy()
            for g, (key, n, i, j, wg) in enumerate(slab):
                out[key] = U[g, :n, :]
    return out
