"""The whole forward's share of the card's peak, in %: the UNet's useful
operations over the window's clouds (2 x neighbour pairs x Cin x Cout for
every conv, stbench/flops.py) over the window's seconds times the published
dense peak at the configuration's precision (989e12 bf16, 67e12 fp32)."""

from stbench.flops import PEAK_FLOPS


def read(rec):
    if rec.window_s <= 0:
        return None
    ops = sum(c.flops() for cloud in rec.clouds for c in rec.inventory(cloud["pool"]))
    return 100.0 * ops / (rec.window_s * PEAK_FLOPS[rec.precision])
