"""HadamardCode generations on tensors.

The counterpart of the device loop of
``grakel_tpu/kernels/hadamard_code.py`` (``_device_run`` with
``_row_hash``, XLA programs there).  A node's code is an int32 row of
width D (a power of two); one generation

1. adds its out-neighbours' rows to each row (edge v -> u adds c[u] to
   c[v]; int32 adds that wrap mod 2^32, as XLA's ``segment_sum`` does),
   except in generation 0, which only hashes;
2. hashes each row, with its node's dimension tag, into two independent
   32-bit murmur-finalized hashes: every element is mixed with its
   column before the wrap-around sums, so permuted or shifted rows do not
   collide; the pair is written as K2's int64 compaction key
   (:func:`grakel_torch.ops.wl.key_hashes` unpacks it,
   :func:`~grakel_torch.ops.wl.compact_key_ids` ranks it).

:func:`hadamard_generations` runs the generations over a ``GraphBatch``'s
sender CSR.  CUDA tensors launch the hand-written kernel K6
(``csrc/hadamard.cu``), one launch a generation into two code buffers
used in turn; CPU tensors take :func:`hadamard_step_plain`, int64 torch
ops masked to 32 bits.  Wrap-around sums are order-free, so both give
the JAX program's hashes bit for bit.
"""

from __future__ import annotations

import torch

from .wl import _fmix32, _mul32, _u_key

__all__ = ["row_hash_plain", "hadamard_step_plain", "hadamard_step_cuda",
           "hadamard_step", "hadamard_generations"]

_M32 = 0xFFFFFFFF
_POS1, _POS2 = 0x9E3779B9, 0xC2B2AE35
_MIX1, _MIX2 = 0x85EBCA6B, 0x27D4EB2F
_TAG1, _TAG2 = 0x9E3779B1, 0x7F4A7C15
_FIN1, _FIN2 = 0x165667B1, 0x7F4A7C15


# --------------------------------------------------------------------- #
# plain versions (CPU tensors; the references the kernel is held against)
# --------------------------------------------------------------------- #

def row_hash_plain(codes, dim_tag):
    """The int64 compaction key of each row of ``codes`` [N, D] (int32 or
    int64 holding int32 values) with its node's ``dim_tag`` [N] (u32
    values), in int64 torch ops: ``_row_hash`` of the JAX package over
    all D columns."""
    c = codes.to(torch.int64) & _M32
    j = torch.arange(c.shape[1], dtype=torch.int64, device=c.device)
    s1 = _fmix32(c ^ _mul32(j, _POS1), _MIX1).sum(1) & _M32
    s2 = _fmix32((c + _mul32(j, _POS2)) & _M32, _MIX2).sum(1) & _M32
    tag = dim_tag.to(torch.int64) & _M32
    h1 = _fmix32(s1 ^ _mul32(tag, _TAG1), _FIN1)
    h2 = _fmix32((s2 + _mul32(tag, _TAG2)) & _M32, _FIN2)
    return _u_key(h1, h2)


def hadamard_step_plain(codes, csr_offsets, csr_targets, dim_tag,
                        propagate):
    """One generation in plain PyTorch: ``(codes', key)``.  ``codes``
    int32 [N, D]; node v's out-neighbours are
    ``csr_targets[csr_offsets[v]:csr_offsets[v + 1]]``.  With
    ``propagate`` each row gains its out-neighbours' rows, summed in
    int64 and wrapped back to int32; without, ``codes'`` is ``codes``."""
    if propagate:
        n = codes.shape[0]
        off = csr_offsets.to(torch.int64)
        send = torch.repeat_interleave(
            torch.arange(n, device=codes.device), off[1:n + 1] - off[:n])
        c = codes.to(torch.int64)
        acc = c.clone()
        acc.index_add_(0, send, c[csr_targets[:send.shape[0]].to(
            torch.int64)])
        codes = (((acc + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)
    return codes, row_hash_plain(codes, dim_tag)


# --------------------------------------------------------------------- #
# K6 wrapper
# --------------------------------------------------------------------- #

def hadamard_step_cuda(codes, csr_offsets, csr_targets, dim_tag, propagate,
                       out=None):
    """Launch K6 (``csrc/hadamard.cu``): one generation over a CSR.
    ``codes`` [N, D], ``csr_offsets`` [N + 1] non-decreasing from 0,
    ``csr_targets`` in [0, N) and ``dim_tag`` [N] are contiguous int32
    CUDA tensors on one device, D a power of two.  The CSR is trusted as
    K2 trusts it (``GraphBatch`` builds and checks it).  With
    ``propagate`` the new rows go to ``out`` (a contiguous int32 [N, D]
    tensor that is not ``codes``; allocated when None).  Returns
    ``(codes', key)``: ``codes'`` is ``out`` when propagating, else
    ``codes``; ``key`` the int64 compaction key [N]."""
    from .. import _build
    dev = codes.device
    ok = (dev.type == "cuda" and codes.dim() == 2
          and codes.dtype == csr_offsets.dtype == csr_targets.dtype
          == dim_tag.dtype == torch.int32
          and csr_offsets.device == csr_targets.device == dim_tag.device
          == dev and csr_offsets.dim() == csr_targets.dim()
          == dim_tag.dim() == 1
          and codes.is_contiguous() and csr_offsets.is_contiguous()
          and csr_targets.is_contiguous() and dim_tag.is_contiguous())
    n = codes.shape[0] if ok else 0
    D = codes.shape[1] if ok else 0
    if not (ok and D > 0 and D & (D - 1) == 0 and n < 1 << 30
            and csr_offsets.shape[0] == n + 1 and dim_tag.shape[0] == n):
        raise ValueError("hadamard_step_cuda: need contiguous int32 CUDA "
                         "tensors on one device: codes [N, D] with D a "
                         "power of two, csr_offsets [N + 1], csr_targets "
                         "[E], dim_tag [N], N < 2^30")
    if propagate:
        if out is None:
            out = torch.empty_like(codes)
        elif not (out.shape == codes.shape and out.dtype == torch.int32
                  and out.device == dev and out.is_contiguous()
                  and out.data_ptr() != codes.data_ptr()):
            raise ValueError("hadamard_step_cuda: out must be a contiguous "
                             "int32 tensor shaped like codes, on its "
                             "device, and not codes itself")
    else:
        out = codes
    key = torch.empty(n, dtype=torch.int64, device=dev)
    _build.launch("grakel_hadamard_step", dev, codes.data_ptr(),
                  out.data_ptr(), csr_offsets.data_ptr(),
                  csr_targets.data_ptr(), dim_tag.data_ptr(),
                  key.data_ptr(), n, D, int(bool(propagate)))
    hadamard_step_cuda.launches += 1
    return out, key


hadamard_step_cuda.launches = 0


def hadamard_step(codes, csr_offsets, csr_targets, dim_tag, propagate,
                  out=None):
    """One generation: K6 for CUDA tensors (into ``out`` when given), the
    plain version for CPU tensors.  Returns ``(codes', key)``."""
    dev = codes.device
    if dev.type == "cuda":
        return hadamard_step_cuda(codes, csr_offsets, csr_targets, dim_tag,
                                  propagate, out)
    if dev.type == "cpu":
        return hadamard_step_plain(codes, csr_offsets, csr_targets, dim_tag,
                                   propagate)
    raise ValueError("hadamard_step: unsupported device %s" % dev)


def hadamard_generations(batch, codes, dim_tag, n_iter):
    """Yield the int64 compaction key of each of ``n_iter`` generations
    over ``batch``'s sender CSR: generation 0 hashes ``codes`` (int32
    [N_pad, D] on the batch's device; never written), each later one
    first adds the out-neighbours' rows.  On the card the rows go back
    and forth between two buffers of the generator's own."""
    off, tgt = batch.csr_offsets, batch.csr_targets
    tag = dim_tag.to(torch.int32).contiguous()
    cur, spare = codes.to(torch.int32).contiguous(), None
    for it in range(n_iter):
        nxt, key = hadamard_step(cur, off, tgt, tag, it > 0, out=spare)
        if it > 0:
            spare = cur if cur is not codes else None
            cur = nxt
        yield key
