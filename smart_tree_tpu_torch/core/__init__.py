"""Sparse voxel core: keys, rulebooks, plans, and the gather-GEMM convs with
their two CUDA kernels."""
