from .grid import grid_knn
from .knn import knn, nn, radius_count

__all__ = ["grid_knn", "knn", "nn", "radius_count"]
