"""Skeleton stage: outlier filter, cell reduction, KNN graph, branch tracer."""

from .connect import connect_skeletons
from .filter import outlier_removal
from .graph import EdgeList, nn_graph
from .path import sample_tree, select_path_points, trace_route
from .skeletonize import Skeletonizer
