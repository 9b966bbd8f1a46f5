"""Batched all-pairs shortest paths on tensors.

The counterpart of ``grakel_tpu/ops/floyd_warshall.py``: whole padded
batches ``adj [n, V, V]`` run one min-plus Floyd-Warshall.  Graphs are
grouped into V-size buckets by the caller so padding waste stays
bounded.

CUDA tensors launch the hand-written kernel K3
(``csrc/floyd_warshall.cu``): one block per graph with the tile in
shared memory for V up to :data:`ROUTE_A_MAX_V`, one launch per k over
the batch in device memory above.  CPU tensors take
:func:`floyd_warshall_plain`, the JAX program in torch ops.  Both are
bit-identical to the JAX program: the same initialisation, the same k
order, one f32 add and one min per update (weighted graphs key the
ShortestPath hash route on the distance bits).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["batched_floyd_warshall", "floyd_warshall_plain",
           "floyd_warshall_cuda", "INF", "ROUTE_A_MAX_V"]

# safe to add two of these without f32 overflow (the JAX package's INF)
INF = np.float32(3.4e38 / 4)
# K3 keeps a graph's V x V f32 tile in one block's shared memory up to
# this V: 64 KB, so three blocks fit in an SM's 227 KB
ROUTE_A_MAX_V = 128


def floyd_warshall_plain(adj, node_mask):
    """APSP over a padded batch in plain torch ops, the JAX program step
    for step (V launches of elementwise ops on a CUDA tensor; the CPU
    path and the reference K3 is held against).

    adj : f32 [n, V, V], 0 meaning "no edge"; node_mask : bool [n, V].
    Returns S f32 [n, V, V]: shortest distances, INF where unreachable
    or where either endpoint is padding, 0 on the valid diagonal."""
    V = adj.shape[1]
    inf = torch.tensor(INF, dtype=torch.float32, device=adj.device)
    zero = torch.zeros((), dtype=torch.float32, device=adj.device)
    node_mask = node_mask.to(torch.bool)
    S = torch.where(adj > 0, adj.to(torch.float32), inf)
    eye = torch.eye(V, dtype=torch.bool, device=adj.device)
    S = torch.where(eye[None], zero, S)
    valid = node_mask[:, :, None] & node_mask[:, None, :]
    S = torch.where(valid, S, inf)
    S = torch.where(eye[None] & node_mask[:, :, None], zero, S)
    for k in range(V):
        S = torch.minimum(S, S[:, :, k, None] + S[:, None, k, :])
    return S


def floyd_warshall_cuda(adj, node_mask):
    """Launch K3 (``csrc/floyd_warshall.cu``).  ``adj`` must be a
    contiguous f32 CUDA tensor [n, V, V] and ``node_mask`` a contiguous
    bool or uint8 tensor [n, V] on the same device.  V <= ROUTE_A_MAX_V
    takes route A (one block per graph, the tile in shared memory),
    larger V route B (one launch per k).  Returns S f32 [n, V, V].  One
    call counts as one launch, whatever the route."""
    from .. import _build
    dev = adj.device
    if not (dev.type == "cuda" and node_mask.device == dev
            and adj.dtype == torch.float32
            and node_mask.dtype in (torch.bool, torch.uint8)
            and adj.dim() == 3 and adj.shape[1] == adj.shape[2]
            and node_mask.shape == adj.shape[:2]
            and adj.is_contiguous() and node_mask.is_contiguous()):
        raise ValueError("floyd_warshall_cuda: need a contiguous f32 CUDA "
                         "tensor adj [n, V, V] and a contiguous bool or "
                         "uint8 node_mask [n, V] on the same device")
    n, V = adj.shape[:2]
    if n >= 1 << 31 or V * V >= 1 << 31:   # the kernel's int indexing
        raise ValueError("floyd_warshall_cuda: shape %s out of range"
                         % (tuple(adj.shape),))
    S = torch.empty_like(adj)
    if n == 0 or V == 0:
        return S
    mask = node_mask.view(torch.uint8) if node_mask.dtype == torch.bool \
        else node_mask
    _build.launch("grakel_floyd_warshall", dev, adj.data_ptr(),
                  mask.data_ptr(), S.data_ptr(), n, V,
                  int(V <= ROUTE_A_MAX_V))
    floyd_warshall_cuda.launches += 1
    return S


floyd_warshall_cuda.launches = 0


def batched_floyd_warshall(adj, node_mask):
    """APSP over a padded batch (see :func:`floyd_warshall_plain`).

    CUDA tensors launch K3; CPU tensors take the plain version."""
    dev = adj.device
    if dev.type == "cuda":
        return floyd_warshall_cuda(
            adj.to(torch.float32).contiguous(),
            node_mask.to(torch.bool).contiguous())
    if dev.type == "cpu":
        return floyd_warshall_plain(adj, node_mask)
    raise ValueError("batched_floyd_warshall: unsupported device %s" % dev)
