"""Histogram-intersection Gram: K[i, j] = sum_l min(A[i, l], B[j, l]).

The counterpart of ``grakel_tpu/ops/intersect.py:min_intersection_gram``,
used by PyramidMatch's level Grams.  min() has no tensor-core mapping,
so CUDA tensors go to the hand-written CUDA kernel K1
(``csrc/min_gram.cu``, the port of the Pallas kernel
``_min_gram_kernel``), which accumulates in f32 as the Pallas kernel
does: integer-valued histograms come out exact below 2^24.  CPU tensors
take the plain version, the pair-tiled broadcast-min-reduce of the JAX
package's ``_min_gram_impl``.

``min_intersection_gram_rounds`` and ``jaccard_gram_rounds`` arrive with
the port's NeighborhoodHash.
"""

from __future__ import annotations

import torch

__all__ = ["min_intersection_gram", "min_gram_plain", "min_gram_cuda"]


def min_gram_plain(A, B, tile=64):
    """Plain PyTorch K[i, j] = sum_l min(A[i, l], B[j, l]) over tiles of
    ``tile`` x ``tile`` pairs, so the [TI, TJ, L] intermediate stays
    bounded.  Works on any device; f32 [n, m]."""
    n, m = A.shape[0], B.shape[0]
    K = torch.empty((n, m), dtype=torch.float32, device=A.device)
    for i in range(0, n, tile):
        a = A[i:i + tile, None, :]
        for j in range(0, m, tile):
            K[i:i + tile, j:j + tile] = torch.minimum(
                a, B[None, j:j + tile, :]).sum(-1)
    return K


def min_gram_cuda(A, B):
    """Launch K1 (``csrc/min_gram.cu``).  ``A`` [n, L] and ``B`` [m, L]
    must be contiguous f32 CUDA tensors on one device.  Returns f32
    [n, m]."""
    from .. import _build
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError("min_gram_cuda: A and B must be CUDA tensors on "
                         "one device")
    for X, name in ((A, "A"), (B, "B")):
        if X.dtype != torch.float32 or X.dim() != 2 \
                or not X.is_contiguous():
            raise ValueError("min_gram_cuda: %s must be a contiguous 2-D "
                             "float32 tensor" % name)
    n, L = A.shape
    m = B.shape[0]
    if B.shape[1] != L:
        raise ValueError("min_gram_cuda: A and B differ in width "
                         "(%d vs %d)" % (L, B.shape[1]))
    if max(n, m, L) >= 1 << 31 or (n + 63) // 64 > 65535:
        raise ValueError("min_gram_cuda: shape (%d, %d, %d) out of range"
                         % (n, m, L))
    K = torch.empty((n, m), dtype=torch.float32, device=A.device)
    if n == 0 or m == 0:
        return K
    lib = _build.load_library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.grakel_min_gram(A.data_ptr(), B.data_ptr(), K.data_ptr(),
                                  n, m, L, stream)
    _build.check(err, "grakel_min_gram")
    min_gram_cuda.launches += 1
    return K


min_gram_cuda.launches = 0


def min_intersection_gram(A, B=None, tile=64):
    """K[i, j] = sum_l min(A[i, l], B[j, l]); B defaults to A.

    A: [n, L], B: [m, L] tensors on one device, taken as f32.  CUDA
    tensors launch K1; CPU tensors take :func:`min_gram_plain`.  Returns
    an f32 [n, m] tensor on that device."""
    B = A if B is None else B
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[1]:
        raise ValueError("min_intersection_gram: need [n, L] and [m, L]")
    if A.device != B.device:
        raise ValueError("min_intersection_gram: A and B on different "
                         "devices")
    A = A.to(torch.float32).contiguous()
    B = B.to(torch.float32).contiguous()
    if A.device.type == "cuda":
        return min_gram_cuda(A, B)
    if A.device.type == "cpu":
        return min_gram_plain(A, B, tile)
    raise ValueError("min_intersection_gram: unsupported device %s"
                     % A.device)
