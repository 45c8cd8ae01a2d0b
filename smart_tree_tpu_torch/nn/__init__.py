"""Sparse UNet modules and checkpoint loading."""
