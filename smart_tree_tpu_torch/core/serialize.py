"""Serialization of sparse voxels into space-filling-curve orders, and the
patch layout that serialized attention reads them in (Point Transformer V3,
Wu et al., CVPR 2024; Pointcept's `serialization/` and
`SerializedAttention.get_padding_and_inverse`).

A voxel's code under an order is its curve index over the block's grid at
`depth` bits an axis, with the batch item (the tile block) in the bits
above, so that every item's voxels form one run of the sorted codes:

  z              the Morton code: bit i of x, y, z at bits 3i+2, 3i+1, 3i
  hilbert        Skilling's transform ("Programming the Hilbert curve",
                 AIP Conf. Proc. 707, 2004) of (x, y, z), interleaved as the
                 Morton code is: the index Pointcept's `hilbert.encode` gives
  z-trans, hilbert-trans   the same of (y, x, z)

The codes of a pooled level are its children's codes shifted down three
bits: for both curves the top 3(d - 1) bits of a depth-d code are the
depth-(d - 1) code of the parent cell coords >> 1 (`coarser_codes`), as
Pointcept's `SerializedPooling` takes them.

Patches follow Pointcept's flash path: an item of at most `patch` voxels
is one patch of its own length; a longer one is padded up to a multiple of
`patch` by repeating, after its last voxel, the voxels one patch before, so
that its last patch holds its last `patch` voxels, and the padding is cut off
again after the attention. `PatchLayout` puts the full patches first, then
the short items, each padded with masked slots to the longest of them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _step(state, octant):
    """One level of a curve's walk, from the top: (digit, next state) of
    `state` at the octant bits (b0, b1, b2) of the source coords' x, y, z.

    The z state is Morton's: the digit is the octant, the state stays. A
    Hilbert state is Skilling's AxestoTranspose ("Programming the Hilbert
    curve", AIP Conf. Proc. 707, 2004) as far as the levels above left it:
    the lower bits of transposed axis a are source axis perm[a]'s, flipped
    where flip[a], and parity is the Gray code's carry, the XOR of the
    levels above. At each level axis 0's lower bits are inverted where an
    axis's bit is set, and else swapped with that axis's; the digit is the
    transposed bits Gray-decoded under the carry."""
    if state == "z":
        return (octant[0] << 2) | (octant[1] << 1) | octant[2], state
    perm, flip, parity = state
    y = [octant[perm[a]] ^ flip[a] for a in range(3)]
    perm, flip = list(perm), list(flip)
    for i in range(3):
        if y[i]:
            flip[0] ^= 1
        elif i:
            perm[0], perm[i] = perm[i], perm[0]
            flip[0], flip[i] = flip[i], flip[0]
    z0, z1 = y[0], y[0] ^ y[1]
    z2 = z1 ^ y[2]
    digit = ((z0 ^ parity) << 2) | ((z1 ^ parity) << 1) | (z2 ^ parity)
    return digit, (tuple(perm), tuple(flip), parity ^ z2)


_HILBERT_START = ((0, 1, 2), (0, 0, 0), 0)
_OCTANTS = [(o >> 2, (o >> 1) & 1, o & 1) for o in range(8)]


@functools.lru_cache(maxsize=None)
def _states():
    """Every state the walks reach, the z state first: {state: index}."""
    index, todo = {"z": 0, _HILBERT_START: 1}, [_HILBERT_START]
    while todo:
        for octant in _OCTANTS:
            nxt = _step(todo[0], octant)[1]
            if nxt not in index:
                index[nxt] = len(index)
                todo.append(nxt)
        todo.pop(0)
    return index


@functools.lru_cache(maxsize=None)
def _tables(levels: int, device: torch.device):
    """(digits, next) int64 [states * 8**levels] on `device`: at entry
    state * 8**levels + (x << 2 levels | y << levels | z), the `levels`
    bits of each source axis from the top, the walk's 3 * `levels` code
    bits and its state below them."""
    index = _states()
    one = [[_step(state, octant) for octant in _OCTANTS] for state in index]
    digit1 = np.array([[d for d, _ in row] for row in one], np.int64)
    next1 = np.array([[index[n] for _, n in row] for row in one], np.int64)
    e = np.arange(8 ** levels)
    axes = (e >> 2 * levels, (e >> levels) & ((1 << levels) - 1), e & ((1 << levels) - 1))
    nxt = np.repeat(np.arange(len(index))[:, None], len(e), axis=1)
    digits = np.zeros_like(nxt)
    for lvl in reversed(range(levels)):
        octant = ((axes[0] >> lvl) & 1) << 2 | ((axes[1] >> lvl) & 1) << 1 | (axes[2] >> lvl) & 1
        digits = (digits << 3) | digit1[nxt, octant]
        nxt = next1[nxt, octant]
    return (torch.from_numpy(digits.reshape(-1)).to(device),
            torch.from_numpy(nxt.reshape(-1)).to(device))


def _walk(coords: torch.Tensor, start: torch.Tensor, depth: int) -> torch.Tensor:
    """Curve codes of int coords [..., N, 3] at `depth` bits an axis, each
    row of the walk starting at `start` (state indices, broadcast against
    [..., N]; host tensors are copied without waiting for the device's
    queued work): three levels a table lookup, from the top."""
    c = coords.to(torch.int64)
    dev = c.device
    state = start.to(dev, non_blocking=True)
    code = torch.zeros(c.shape[:-1], dtype=torch.int64, device=dev)
    top = depth
    for levels in ([depth % 3] if depth % 3 else []) + [3] * (depth // 3):
        top -= levels
        digits, nxt = _tables(levels, dev)
        w = torch.tensor([1 << 2 * levels, 1 << levels, 1]).to(dev, non_blocking=True)
        e = state * 8 ** levels + (((c >> top) & ((1 << levels) - 1)) * w).sum(-1)
        code = (code << 3 * levels) | digits[e]
        state = nxt[e]
    return code


def z_order(coords: torch.Tensor, depth: int = 21) -> torch.Tensor:
    """Morton codes of int coords [..., N, 3] (x, y, z) below 2**depth: bit
    i of x, y, z at bits 3i+2, 3i+1, 3i."""
    return _walk(coords, torch.tensor(_states()["z"]), depth)


def hilbert(coords: torch.Tensor, depth: int) -> torch.Tensor:
    """Hilbert indices of int coords [..., N, 3] on a grid of 2**depth an axis
    (Skilling's transform, its transposed index interleaved as the Morton
    code is)."""
    return _walk(coords, torch.tensor(_states()[_HILBERT_START]), depth)


def encode(coords: torch.Tensor, batch: torch.Tensor, depth: int,
           orders: Sequence[str] = ORDERS) -> torch.Tensor:
    """[len(orders), N] int64 codes of voxels at int coords [N, 3] in batch
    items `batch` [N]: the item above 3 * depth bits of curve index. Every
    order walks in one stack, so that the device ops a plan queues do not
    grow with the number of orders."""
    states = _states()
    start = []
    for name in orders:
        if not name.startswith(("hilbert", "z")):
            raise ValueError(f"unknown order {name!r}")
        start.append(states[_HILBERT_START] if name.startswith("hilbert") else states["z"])
    c = coords.to(torch.int64)
    trans = c[:, [1, 0, 2]]
    src = torch.stack([trans if name.endswith("-trans") else c for name in orders])
    codes = _walk(src, torch.tensor(start)[:, None], depth)
    return codes | (batch.to(torch.int64)[None] << (3 * depth))


def coarser_codes(codes: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """The codes of a pooled level from a child of each parent (any child:
    `child` [M] rows of the finer level): its codes shifted down 3 bits."""
    return codes[:, child] >> 3


def orders_and_inverses(codes: torch.Tensor):
    """(order, inverse), each [O, N]: order[o, j] is the row at serialized
    position j under order o, inverse[o, row] its position."""
    order = torch.argsort(codes, dim=1)
    pos = torch.arange(codes.shape[1], device=codes.device).expand_as(order)
    inverse = torch.empty_like(order).scatter_(1, order, pos)
    return order, inverse


@dataclass(frozen=True)
class PatchLayout:
    """Where each serialized position goes in the padded patches of one
    level. Slots are flat: the `n_full` full patches of `patch` slots first,
    then `n_short` short items of `short_len` slots each (masked past the
    item's length).

    gather [slots]  the serialized position each slot reads
    unpad  [N]      the slot each serialized position's output comes from
    short_mask      [n_short, short_len] bool, True on an item's own voxels
    pad_rows        slots the padding of the long items repeated"""

    gather: torch.Tensor
    unpad: torch.Tensor
    short_mask: torch.Tensor
    patch: int
    n_full: int
    n_short: int
    short_len: int
    pad_rows: int

    @property
    def patches(self) -> int:
        return self.n_full + self.n_short


def _upload(device, *rows):
    """Small host int lists as int64 tensors on `device`, in one copy that
    does not wait for the device's queued work."""
    flat = torch.tensor([v for r in rows for v in r], dtype=torch.int64)
    flat = flat.to(device, non_blocking=True)
    return torch.split(flat, [len(r) for r in rows])


def patch_layout(offsets: torch.Tensor, counts: Sequence[int], patch: int) -> PatchLayout:
    """The layout of items whose serialized positions are the runs
    [offsets[i], offsets[i + 1]) of `offsets` ([B + 1] int64 on the device),
    `counts` the same runs' lengths, read to the host."""
    dev = offsets.device
    counts = [int(n) for n in counts]
    full = [n > patch for n in counts]
    padded = [-(-n // patch) * patch if f else 0 for n, f in zip(counts, full)]
    short_len = max([n for n, f in zip(counts, full) if 0 < n and not f], default=0)
    # items in slot order: the long ones, then the short ones
    seq = [i for i, f in enumerate(full) if f] + \
        [i for i, (n, f) in enumerate(zip(counts, full)) if 0 < n and not f]
    slots = [padded[i] if full[i] else short_len for i in seq]
    base = [sum(slots[:k]) for k in range(len(seq))]
    n_full_slots, n_short, total = sum(padded), len(seq) - sum(full), sum(slots)
    seq_t, base_t, slots_t, full_t = _upload(dev, seq, base, slots, full)
    n = offsets[1:] - offsets[:-1]
    k = torch.repeat_interleave(torch.arange(len(seq), device=dev), slots_t,
                                output_size=total)
    item = seq_t[k]
    j = torch.arange(total, device=dev) - base_t[k]
    own = j < n[item]
    gather = offsets[item] + torch.where(own, j, torch.where(full_t[item] > 0, j - patch, 0))
    # each serialized position's slot: its item's base plus its rank in it
    slot_base = torch.zeros(len(counts), dtype=torch.int64, device=dev).index_copy_(
        0, seq_t, base_t)
    n_rows = sum(counts)
    owner = torch.repeat_interleave(torch.arange(len(counts), device=dev), n,
                                    output_size=n_rows)
    unpad = slot_base[owner] + torch.arange(n_rows, device=dev) - offsets[owner]
    return PatchLayout(gather=gather, unpad=unpad,
                       short_mask=own[n_full_slots:].reshape(n_short, short_len),
                       patch=patch, n_full=n_full_slots // patch, n_short=n_short,
                       short_len=short_len,
                       pad_rows=sum(p - c for p, c in zip(padded, counts) if p))
