"""Batched all-pairs shortest paths on tensors.

The counterpart of ``grakel_tpu/ops/floyd_warshall.py``: whole padded
batches ``adj [n, V, V]`` run one min-plus Floyd-Warshall.  Graphs are
grouped into V-size buckets by the caller so padding waste stays
bounded.

CUDA tensors launch the hand-written kernel K3
(``csrc/floyd_warshall.cu``) on one of three routes, chosen by
:func:`fw_route`: "tile" for V up to :data:`ROUTE_A_MAX_V` (register
micro-tiles, several graphs per block, shaped by :func:`fw_tile_config`),
"blocked" above it when the caller promises integral weights (a
three-phase blocked Floyd-Warshall in 32-wide tiles), "per_k" otherwise
(one launch per k).  CPU tensors take :func:`floyd_warshall_plain`, the
JAX program in torch ops.  "tile" and "per_k" keep the JAX program's
sequence of updates (the same initialisation, the same k order, one f32
add and one min per update) and are bit-identical to it for any
weights: weighted graphs key the ShortestPath hash route on the distance
bits.  "blocked" reassociates path sums, which is exact only for
integral weights.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["batched_floyd_warshall", "floyd_warshall_plain",
           "floyd_warshall_cuda", "fw_route", "fw_tile_config", "INF",
           "ROUTE_A_MAX_V", "BLOCKED_TILE", "TILE_WIDTHS",
           "TILE_MAX_THREADS"]

# safe to add two of these without f32 overflow (the JAX package's INF)
INF = np.float32(3.4e38 / 4)
# largest V on route "tile": one graph at T = 8 is 16 x 16 threads
ROUTE_A_MAX_V = 128
# route "blocked": tile width (csrc/floyd_warshall.cu kB)
BLOCKED_TILE = 32
# route "tile": (largest V, micro-tile width T) of each instantiation.
# A sweep of T and G at the NCI1-scale buckets on an H100 (chip_smoke.py,
# "tile_sweep") found T = 2 fastest at V = 16 and 24 and T = 4 at V =
# 32-56; T = 8 is the one of the three that fits V = 128 in 256 threads.
TILE_WIDTHS = ((24, 2), (64, 4), (128, 8))
# block size cap of each instantiation (the kernel's __launch_bounds__:
# 64 cells a thread at T = 8 need more than the 128 registers of 512)
TILE_MAX_THREADS = {2: 512, 4: 512, 8: 256}
# route "tile": graphs of one block fill at least this many threads
_TILE_MIN_THREADS = 128
_ROUTE_CODES = {"tile": 0, "blocked": 1, "per_k": 2}


def fw_route(V, integral=False):
    """K3's route for a batch of width V: "tile" up to ROUTE_A_MAX_V,
    above it "blocked" when the weights are integral (the caller's
    promise: path sums are exact, so reassociating them changes no
    bit), else "per_k"."""
    if V <= ROUTE_A_MAX_V:
        return "tile"
    return "blocked" if integral else "per_k"


def fw_tile_config(n, V):
    """(T, G) of route "tile" for n graphs of width V: the micro-tile
    width T of V's instantiation (TILE_WIDTHS) and the graphs per block
    G.  A graph takes ceil(V / T)^2 threads; a block holds enough graphs
    for _TILE_MIN_THREADS threads (a warp for each of an SM's four
    schedulers), never more than n, and is otherwise kept small so that
    many blocks spread over the SMs."""
    T = next(t for w, t in TILE_WIDTHS if V <= w)
    tpg = (-(-V // T)) ** 2
    return T, max(1, min(_TILE_MIN_THREADS // tpg, n))


def floyd_warshall_plain(adj, node_mask, integral=False):
    """APSP over a padded batch in plain torch ops, the JAX program step
    for step (V launches of elementwise ops on a CUDA tensor; the CPU
    path and the reference K3 is held against).  ``integral`` is
    accepted for the signature of :func:`batched_floyd_warshall` and
    changes nothing.

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


def floyd_warshall_cuda(adj, node_mask, integral=False, tile=None):
    """Launch K3 (``csrc/floyd_warshall.cu``).  ``adj`` must be a
    contiguous f32 CUDA tensor [n, V, V] and ``node_mask`` a contiguous
    bool or uint8 tensor [n, V] on the same device.  The route is
    :func:`fw_route` ``(V, integral)``; ``integral`` promises integer
    edge weights with (V - 1) * max weight < 2^24 and is not checked.
    ``tile`` = (T, G) overrides :func:`fw_tile_config` on route "tile"
    (for measurements).  Returns S f32 [n, V, V].  One call counts as
    one launch, whatever the route; ``route_launches`` counts them by
    route."""
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
    route = fw_route(V, integral)
    T, G = 0, 0
    if route == "tile":
        T, G = fw_tile_config(n, V) if tile is None else tile
        if (T not in TILE_MAX_THREADS or G < 1
                or G * (-(-V // T)) ** 2 > TILE_MAX_THREADS[T]):
            raise ValueError("floyd_warshall_cuda: tile %s does not fit "
                             "V = %d" % ((T, G), V))
    mask = node_mask.view(torch.uint8) if node_mask.dtype == torch.bool \
        else node_mask
    _build.launch("grakel_floyd_warshall", dev, adj.data_ptr(),
                  mask.data_ptr(), S.data_ptr(), n, V, _ROUTE_CODES[route],
                  T, G)
    floyd_warshall_cuda.launches += 1
    floyd_warshall_cuda.route_launches[route] += 1
    return S


floyd_warshall_cuda.launches = 0
floyd_warshall_cuda.route_launches = dict.fromkeys(_ROUTE_CODES, 0)


def batched_floyd_warshall(adj, node_mask, integral=False):
    """APSP over a padded batch (see :func:`floyd_warshall_plain`).
    ``integral`` promises integer edge weights (see
    :func:`floyd_warshall_cuda`).

    CUDA tensors launch K3; CPU tensors take the plain version."""
    dev = adj.device
    if dev.type == "cuda":
        return floyd_warshall_cuda(
            adj.to(torch.float32).contiguous(),
            node_mask.to(torch.bool).contiguous(), integral)
    if dev.type == "cpu":
        return floyd_warshall_plain(adj, node_mask, integral)
    raise ValueError("batched_floyd_warshall: unsupported device %s" % dev)
