"""Canonical codes for small graphs (graphlets of s <= 8 vertices).

The counterpart of ``grakel_tpu/ops/canonical.py``.  Two graphlets are
isomorphic iff their canonical codes are equal, so GraphletSampling bins
samples by a dict lookup on the code.  The code of an undirected
graphlet of size s is the minimum, over all s! vertex permutations p, of
its bit-packed upper triangle under p: bit k (the k-th pair (i, j),
i < j, in row order) is ``A[p[i], p[j]]``, so s(s-1)/2 <= 28 bits.
Directed inputs are symmetrized; a graphlet of s <= 1 vertices has code
0.

A graphlet travels as one int64 adjacency mask, bit ``u * 8 + v`` set
for each edge u-v (u != v, both directions; :func:`adjacency_masks`).
CUDA tensors launch the hand-written kernel K7 (``csrc/canonical.cu``):
a group of lanes a graphlet (one lane at s = 2 up to a whole warp from
s = 6), each lane walking its share of the permutations in
lexicographic order, decoded from its first index and then stepped in
place, the group reducing the minimum by shuffles.  No permutation table
is built, so every s up to 8 (40320 permutations) takes the same kernel.
CPU tensors take :func:`canonical_codes_plain`, the JAX program's
gather-and-min (``_codes_impl``) in torch, chunked the same way.  The
codes are integers: all three agree bit for bit.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["canonical_codes", "canonical_codes_plain", "canonical_codes_cuda",
           "adjacency_masks", "MAX_DEVICE_SIZE"]

MAX_DEVICE_SIZE = 8  # s(s-1)/2 = 28 bits fits int32

_PERM_CACHE = {}


def _perm_pair_index(s):
    """[s!, s(s-1)/2] flat indices into an s*s adjacency such that row p
    lists the upper-triangle entries of the p-permuted matrix."""
    cached = _PERM_CACHE.get(s)
    if cached is not None:
        return cached
    pairs = [(i, j) for i in range(s) for j in range(i + 1, s)]
    idx = np.array(
        [[p[i] * s + p[j] for (i, j) in pairs]
         for p in itertools.permutations(range(s))], dtype=np.int32)
    _PERM_CACHE[s] = idx
    return idx


def adjacency_masks(adjs):
    """int64 [B] masks of a list of square 0/1 arrays of one size s <= 8:
    bit ``u * 8 + v`` is set when ``adjs[b][u, v]`` or ``adjs[b][v, u]``
    is nonzero and u != v (the diagonal is never read)."""
    A = np.stack([np.asarray(a) for a in adjs]).astype(bool)
    A = A | np.transpose(A, (0, 2, 1))
    s = A.shape[1]
    A[:, np.arange(s), np.arange(s)] = False
    u, v = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    shift = (u * 8 + v).reshape(-1).astype(np.uint64)
    bits = A.reshape(len(adjs), s * s).astype(np.uint64) << shift
    return np.bitwise_or.reduce(bits, axis=1).view(np.int64)


def canonical_codes_plain(masks, s):
    """int64 [B] codes of the graphlets in ``masks`` (int64 [B], the
    layout of :func:`adjacency_masks`) of size ``s``: the gather of every
    permutation's upper triangle, the weighted bit sum and the minimum,
    in chunks that keep the gather under ~64M elements."""
    B = masks.shape[0]
    if s <= 1 or B == 0:
        return torch.zeros(B, dtype=torch.int64, device=masks.device)
    uv = torch.arange(s, device=masks.device)
    shift = (uv[:, None] * 8 + uv[None, :]).reshape(-1)
    flat = (masks[:, None] >> shift[None, :]) & 1               # [B, s*s]
    idx = torch.from_numpy(_perm_pair_index(s).astype(np.int64)).to(
        masks.device)                                            # [P, nb]
    nb = idx.shape[1]
    weights = torch.ones(nb, dtype=torch.int64, device=masks.device) \
        << torch.arange(nb, device=masks.device)
    chunk = max(1, (1 << 26) // max(idx.shape[0] * s * s, 1))
    out = []
    for lo in range(0, B, chunk):
        bits = flat[lo:lo + chunk][:, idx]                       # [b, P, nb]
        out.append((bits * weights).sum(-1).amin(1))
    return torch.cat(out)


def canonical_codes_cuda(masks, s):
    """Launch K7 (``csrc/canonical.cu``) on ``masks`` (contiguous int64
    [B] on a CUDA device, the layout of :func:`adjacency_masks`) of size
    2 <= ``s`` <= 8.  Returns the int32 [B] codes (one launch)."""
    from .. import _build
    dev = masks.device
    if not (dev.type == "cuda" and masks.dtype == torch.int64
            and masks.dim() == 1 and masks.is_contiguous()
            and 2 <= int(s) <= MAX_DEVICE_SIZE and masks.shape[0] < 1 << 26):
        raise ValueError("canonical_codes_cuda: need a contiguous int64 [B] "
                         "CUDA tensor of masks (B < 2^26) and 2 <= s <= %d"
                         % MAX_DEVICE_SIZE)
    B = masks.shape[0]
    codes = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _build.launch("grakel_canonical_codes", dev, masks.data_ptr(),
                      codes.data_ptr(), B, int(s))
        canonical_codes_cuda.launches += 1
    return codes


canonical_codes_cuda.launches = 0


def canonical_codes(adjs, device=None):
    """Canonical int64 codes (numpy [B]) for a list of small square 0/1
    adjacency arrays, all the SAME size s <= MAX_DEVICE_SIZE, on
    ``device`` (None: the ambient device, else cuda).  Directed inputs
    are symmetrized (undirected-isomorphism semantics)."""
    if len(adjs) == 0:
        return np.zeros(0, np.int64)
    s = adjs[0].shape[0]
    if s > MAX_DEVICE_SIZE:
        raise ValueError("device canonical codes support size <= %d"
                         % MAX_DEVICE_SIZE)
    if s <= 1:
        return np.zeros(len(adjs), np.int64)
    dev = resolve_device(device)
    masks = torch.from_numpy(adjacency_masks(adjs)).to(dev)
    if dev.type == "cpu":
        codes = canonical_codes_plain(masks, s)
    elif dev.type == "cuda":
        codes = canonical_codes_cuda(masks, s)
    else:
        raise ValueError("canonical_codes: unsupported device %s" % dev)
    return codes.cpu().numpy().astype(np.int64)
