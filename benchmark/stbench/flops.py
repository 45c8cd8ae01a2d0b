"""The work of one forward, counted from the voxels the benchmark hands the
program, never from the program's plans: the SmartTree inventory of convs
over the reference's levels (reference/unet.py::build_levels), each conv's
operations 2 x (neighbour pairs that exist) x Cin x Cout and its bytes each
input row, the weights and each output row once, at the precision's width.

The 27-column convs are the ones the slab kernel (B1) takes at bfloat16;
the 1 x 1 convs (input, projections, heads) are counted in the step's
operations only.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
WIDTH = {"bfloat16": 2, "float32": 4}
HEADS = ((8, 8, 4, 1), (8, 8, 4, 3), (8, 8, 4, 2))


@dataclass
class Conv:
    pairs: int       # neighbour pairs that exist (rows for a 1 x 1 conv)
    rows_in: int
    rows_out: int
    cin: int
    cout: int
    k3: int

    def flops(self):
        return 2 * self.pairs * self.cin * self.cout

    def bytes(self, width):
        return width * (self.rows_in * self.cin + self.k3 * self.cin * self.cout
                        + self.rows_out * self.cout)

    def bound_s(self, precision):
        return max(self.flops() / PEAK_FLOPS[precision],
                   self.bytes(WIDTH[precision]) / PEAK_BYTES)


def inventory(levels, planes=(8, 16, 32, 64), in_channels=3, heads=HEADS):
    """Every conv of one forward over `levels`; `heads` each head's widths."""
    n = [lv.coords.shape[0] for lv in levels]
    subm = [int((lv.subm >= 0).sum()) for lv in levels]
    strided = [int((lv.down >= 0).sum()) for lv in levels[1:]]
    convs = [Conv(n[0], n[0], n[0], in_channels, planes[0], 1)]
    for lvl, p in enumerate(planes):
        convs += [Conv(subm[lvl], n[lvl], n[lvl], p, p, 27)] * 2          # Head
        if lvl + 1 < len(planes):
            q = planes[lvl + 1]
            convs.append(Conv(strided[lvl], n[lvl], n[lvl + 1], p, q, 27))  # Encode
            convs.append(Conv(strided[lvl], n[lvl + 1], n[lvl], q, p, 27))  # Decode
            convs.append(Conv(n[lvl], n[lvl], n[lvl], 2 * p, p, 1))         # Tail identity
            convs.append(Conv(subm[lvl], n[lvl], n[lvl], 2 * p, p, 27))     # Tail
            convs.append(Conv(subm[lvl], n[lvl], n[lvl], p, p, 27))
    for head in heads:
        convs += [Conv(n[0], n[0], n[0], a, b, 1) for a, b in zip(head[:-1], head[1:])]
    return convs
