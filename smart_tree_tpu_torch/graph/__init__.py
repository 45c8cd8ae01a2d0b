from .components import component_sizes, connected_components
from .shortcuts import chain_shortcut_table, chain_shortcuts
from .sssp import sssp, sssp_multi, tree_distances
from .table import NeighborTable, build_neighbor_table

__all__ = [
    "NeighborTable",
    "build_neighbor_table",
    "chain_shortcut_table",
    "chain_shortcuts",
    "component_sizes",
    "connected_components",
    "sssp",
    "sssp_multi",
    "tree_distances",
]
