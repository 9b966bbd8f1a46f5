"""Multi-GPU distribution layer: meshes of ranks on ``torch.distributed``
and sharded Gram tiling.

The counterpart of ``grakel_tpu/parallel/``: graphs are sharded over a
1-D mesh of ranks (one process a GPU, NCCL; gloo on the CPU), features
are extracted locally, and the N x N Gram assembles as row-block tiles
with a ring exchange of feature blocks, so each step overlaps one GEMM
with one hop.  Every rank calls the same function with the same input
and gets the full result.  ``python -m grakel_torch.parallel.launch``
runs a function in P ranks on one host.
"""

from .mesh import Mesh, make_mesh, local_mesh, distributed_init
from .gram import (ring_gram, ring_rect_gram, sharded_counts_gram,
                   sharded_counts_gram_rect, shard_batch)
from .wl import distributed_wl_gram
from .large_graph import (edge_partitioned_wl_features,
                          large_graph_wl_gram, LargeGraphWL)

__all__ = ["make_mesh", "local_mesh", "distributed_init", "ring_gram",
           "ring_rect_gram", "sharded_counts_gram",
           "sharded_counts_gram_rect",
           "shard_batch", "distributed_wl_gram",
           "edge_partitioned_wl_features", "large_graph_wl_gram",
           "LargeGraphWL", "Mesh"]
