from .grid import grid_knn
from .grid_count import grid_radius_count
from .knn import knn, nn, radius_count

__all__ = ["grid_knn", "grid_radius_count", "knn", "nn", "radius_count"]
