from .knn import knn, nn, radius_count

__all__ = ["knn", "nn", "radius_count"]
