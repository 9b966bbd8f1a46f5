"""Graph kernels of the port (scikit-learn-style fit/transform)."""

from .base import Kernel
from .histogram import VertexHistogram, EdgeHistogram
from .pyramid_match import PyramidMatch
from .shortest_path import ShortestPath, ShortestPathAttr
from .weisfeiler_lehman import WeisfeilerLehman
from .core_framework import CoreFramework
from .neighborhood_hash import NeighborhoodHash
from .wl_optimal_assignment import WeisfeilerLehmanOptimalAssignment
from .hadamard_code import HadamardCode
from .propagation import Propagation, PropagationAttr
from .odd_sth import OddSth
from .nspd import NeighborhoodSubgraphPairwiseDistance
from .subgraph_matching import SubgraphMatching
from .graphlet_sampling import GraphletSampling
from .random_walk import RandomWalk, RandomWalkLabeled
from .svm_theta import SvmTheta
from .lovasz_theta import LovaszTheta
from .graph_hopper import GraphHopper
from .multiscale_laplacian import MultiscaleLaplacian

__all__ = [
    "Kernel",
    "VertexHistogram",
    "EdgeHistogram",
    "PyramidMatch",
    "ShortestPath",
    "ShortestPathAttr",
    "WeisfeilerLehman",
    "CoreFramework",
    "NeighborhoodHash",
    "WeisfeilerLehmanOptimalAssignment",
    "HadamardCode",
    "Propagation",
    "PropagationAttr",
    "OddSth",
    "NeighborhoodSubgraphPairwiseDistance",
    "SubgraphMatching",
    "GraphletSampling",
    "RandomWalk",
    "RandomWalkLabeled",
    "SvmTheta",
    "LovaszTheta",
    "GraphHopper",
    "MultiscaleLaplacian",
]
