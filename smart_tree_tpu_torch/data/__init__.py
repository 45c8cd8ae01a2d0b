"""Clouds, file input, synthetic trees and inference tiling (host, numpy)."""
