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
a lane a graphlet, every lane of a warp stepping the same entry of
:func:`perm_table` (the s! permutations in lexicographic order, packed
four bits an element) at the same time, each keeping its own minimum of
a key whose bits are the code's in the same order of significance
(:func:`canonical_codes_walk_plain` is that walk in torch).  CPU tensors
take :func:`canonical_codes_plain`, the JAX program's gather-and-min
(``_codes_impl``) in torch, chunked the same way.  The codes are
integers: all agree bit for bit.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["canonical_codes", "canonical_codes_plain", "canonical_codes_cuda",
           "canonical_codes_walk_plain", "perm_table", "adjacency_masks",
           "MAX_DEVICE_SIZE", "K7_S8_SHARED"]

MAX_DEVICE_SIZE = 8  # s(s-1)/2 = 28 bits fits int32
# K7's table at s = 8 (161,280 bytes): in shared memory (the opt-in, one
# block an SM) when True, else read through L1.  chip_smoke.py times
# both: on an H100 the L1 route took 16.72 ms on 100,000 graphlets, the
# shared one 20.55 (PERF.md)
K7_S8_SHARED = False

_PERM_CACHE = {}
_TABLE_CACHE = {}
_DEVICE_TABLES = {}


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


def perm_table(s):
    """uint32 [s!]: every permutation p of range(s) in lexicographic
    order (``itertools.permutations``), packed four bits an element,
    ``p[i]`` at bits 4 i .. 4 i + 3.  K7 walks it."""
    cached = _TABLE_CACHE.get(s)
    if cached is None:
        perms = np.array(list(itertools.permutations(range(s))),
                         np.uint32).reshape(-1, s)
        cached = np.bitwise_or.reduce(
            perms << (4 * np.arange(s, dtype=np.uint32)), axis=1)
        cached = cached.astype(np.uint32)
        _TABLE_CACHE[s] = cached
    return cached


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


def canonical_codes_walk_plain(masks, s):
    """int64 [B] codes by K7's walk, in torch: for each permutation w of
    :func:`perm_table`, the key with bit ``8 i + j`` = ``A[p_i, p_j]``
    for i < j (the rows permuted as bytes, then bit ``p_j`` of every row
    moved to bit j and the rows i < j kept), its minimum over the table,
    packed into the code.  Equal to :func:`canonical_codes_plain` bit for
    bit: the key's bits are the code's in the same order."""
    B = masks.shape[0]
    if s <= 1 or B == 0:
        return torch.zeros(B, dtype=torch.int64, device=masks.device)
    dev = masks.device
    w = torch.from_numpy(perm_table(s).astype(np.int64)).to(dev)     # [P]
    nib = (w[:, None] >> (4 * torch.arange(s, device=dev))) & 15    # [P, s]
    byte = 8 * torch.arange(8, device=dev)
    rows = (masks[:, None] >> byte) & 0xFF                          # [B, 8]
    chunk = max(1, (1 << 22) // (w.shape[0] * 8))
    best = []
    for lo in range(0, B, chunk):
        r = rows[lo:lo + chunk, None, :].expand(-1, w.shape[0], 8)
        prow = torch.gather(r, 2, nib[None].expand(r.shape[0], -1, -1))
        key = torch.zeros(prow.shape[:2], dtype=torch.int64, device=dev)
        for j in range(1, s):
            # bit p_j of the rows i < j
            bit = (prow[:, :, :j] >> nib[None, :, j:j + 1]) & 1
            key |= (bit << (byte[:j] + j)).sum(-1)
        best.append(key.amin(1))
    best = torch.cat(best)
    code = torch.zeros(B, dtype=torch.int64, device=dev)
    k = 0
    for i in range(s):
        for j in range(i + 1, s):
            code |= ((best >> (8 * i + j)) & 1) << k
            k += 1
    return code


def _device_table(s, dev):
    """:func:`perm_table` on ``dev`` as int32, uploaded once a device."""
    key = (s, str(dev))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.from_numpy(perm_table(s).view(np.int32)).to(dev)
        _DEVICE_TABLES[key] = t
    return t


def canonical_codes_cuda(masks, s, shared=None):
    """Launch K7 (``csrc/canonical.cu``) on ``masks`` (contiguous int64
    [B] on a CUDA device, the layout of :func:`adjacency_masks`) of size
    2 <= ``s`` <= 8.  The table of :func:`perm_table` sits in shared
    memory for s <= 7; at s = 8 in shared memory when ``shared`` (default
    ``K7_S8_SHARED``), else it is read through L1.  Returns the int32 [B]
    codes (one launch)."""
    from .. import _build
    dev = masks.device
    if not (dev.type == "cuda" and masks.dtype == torch.int64
            and masks.dim() == 1 and masks.is_contiguous()
            and 2 <= int(s) <= MAX_DEVICE_SIZE and masks.shape[0] < 1 << 26):
        raise ValueError("canonical_codes_cuda: need a contiguous int64 [B] "
                         "CUDA tensor of masks (B < 2^26) and 2 <= s <= %d"
                         % MAX_DEVICE_SIZE)
    s = int(s)
    shared = K7_S8_SHARED if shared is None else bool(shared)
    B = masks.shape[0]
    codes = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        table = _device_table(s, dev)
        _build.launch("grakel_canonical_codes", dev, masks.data_ptr(),
                      table.data_ptr(), codes.data_ptr(), B, s,
                      int(shared or s < 8))
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
