"""Skeleton stage: outlier filter, cell reduction, KNN graph, branch tracer."""
