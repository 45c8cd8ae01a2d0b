"""Analytic roofline of the sparse-UNet forward, the counterpart of
`tools/roofline.py`, against the H100's peaks.

Walks the conv inventory of SmartTree (`nn/model.py`, `nn/blocks.py`) at a
batch's level rows and counts per level and in total:

  - gather indices issued (27 per output row of a 27-column conv);
  - device-memory bytes of the gather + GEMM path: read `cin` items per
    index, write the gathered [m, k*cin] matrix, read it back into the GEMM,
    write the [m, cout] output;
  - FLOPs of the GEMMs (2 m k cin cout).

A batch is given either by its capacity, for the JAX tool's schedule (each
level `factor` times the one above, at least 256 rows: the static plans of
the JAX package), or by its exact level rows, the rows the port's forward
runs (`ModelInference.plan_rows`, the bench's `batch_level_rows`).

Caveat: the bytes model the materialised gather + GEMM of the XLA path
(route 3 in the port). The slab kernel (`csrc/slab_conv.cu`), which takes
the bf16 27-column convs, never materialises the gathered matrix, so the
bytes share is a yardstick of that path, not of the kernel. The FLOP count
is the same whatever implements the convs. No per-index gather cost is
modelled: it has not been measured on the H100.

    python -m smart_tree_tpu_torch.tools.roofline --capacity 131072 [--measured-ms 12.5]
    python -m smart_tree_tpu_torch.tools.roofline --capacity 2963,7233,2260,610 ... --measured-ms T

With several batches (those of one forward, e.g. the bench's
`batch_level_rows`, each level's rows joined by commas) the totals are the
whole forward's, and `--measured-ms` is its device time (the bench's
`device_step_s`).
"""

from __future__ import annotations

import argparse

# H100 SXM published peaks (dense): device memory bytes/s; bf16 tensor-core
# and fp32 (non-tensor-core) FLOP/s. Both at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}
HEADS = ((8, 8, 4, 1), (8, 8, 4, 3), (8, 8, 4, 2))


def level_convs(planes, lvl):
    """[(rows_key, k, cin, cout)] for UNet level lvl; rows_key 'n' = this
    level's capacity, 'n+1' = next level's (the Encode output rows)."""
    c = planes[lvl]
    convs = [("n", 27, c, c), ("n", 27, c, c)]  # Head ResBlock
    if lvl < len(planes) - 1:
        cn = planes[lvl + 1]
        convs += [
            ("n+1", 27, c, cn),        # Encode (strided; rulebook over out rows)
            ("n", 27, cn, c),          # Decode (inverse)
            ("n", 1, 2 * c, c),        # Tail identity projection (1^3)
            ("n", 27, 2 * c, c),       # Tail conv 1 (on skip concat)
            ("n", 27, c, c),           # Tail conv 2
        ]
    return convs


def analyze(capacity, planes=(8, 16, 32, 64), factor=0.5, itemsize=4,
            input_channels=3, heads=HEADS):
    """(level rows, per-level dicts, totals) of indices, bytes and FLOPs for
    one batch: `capacity` an int (the factor schedule from it) or every
    level's exact rows."""
    if isinstance(capacity, int):
        caps = [capacity]
        for _ in planes[1:]:
            caps.append(max(int(caps[-1] * factor), 256))
    else:
        caps = [int(n) for n in capacity]
        if len(caps) != len(planes):
            raise ValueError(f"{len(caps)} level rows for {len(planes)} levels")
    total = dict(indices=0, bytes=0, flops=0)
    per_level = []
    for lvl in range(len(planes)):
        n = caps[lvl]
        n_next = caps[lvl + 1] if lvl + 1 < len(caps) else 0
        lv = dict(level=lvl, cap=n, indices=0, bytes=0, flops=0)
        convs = list(level_convs(planes, lvl))
        if lvl == 0:
            convs.insert(0, ("n", 1, input_channels, planes[0]))  # input conv
            for hp in heads:  # SparseFC stacks: 1^3 convs
                for cin, cout in zip(hp[:-1], hp[1:]):
                    convs.append(("n", 1, cin, cout))
        for rk, k, cin, cout in convs:
            m = n if rk == "n" else n_next
            idx = m * k if k > 1 else 0  # 1^3 convs index identity rows (free)
            lv["indices"] += idx
            lv["bytes"] += idx * cin * itemsize + 2 * m * k * cin * itemsize \
                + m * cout * itemsize
            lv["flops"] += 2 * m * k * cin * cout
        per_level.append(lv)
        for f in ("indices", "bytes", "flops"):
            total[f] += lv[f]
    return caps, per_level, total


def forward_totals(capacities, planes=(8, 16, 32, 64), factor=0.5, itemsize=4,
                   input_channels=3, heads=HEADS):
    """`analyze`'s totals summed over the batches of one forward, each a
    capacity or its exact level rows."""
    total = dict(indices=0, bytes=0, flops=0)
    for cap in capacities:
        _, _, t = analyze(cap, planes, factor, itemsize, input_channels, heads)
        for f in total:
            total[f] += t[f]
    return total


def achieved(total, seconds, precision="bfloat16"):
    """FLOP/s and bytes/s of `total` done in `seconds`, each beside its share
    of the H100's peak."""
    flops, bytes_ = total["flops"] / seconds, total["bytes"] / seconds
    return {"flops_per_s": flops, "flop_share": flops / PEAK_FLOPS[precision],
            "bytes_per_s": bytes_, "bytes_share": bytes_ / HBM_BYTES_PER_S}


def _batch(text: str):
    """A --capacity value: an int, or level rows joined by commas."""
    rows = [int(v) for v in text.split(",")]
    return rows[0] if len(rows) == 1 else tuple(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m smart_tree_tpu_torch.tools.roofline")
    ap.add_argument("--capacity", type=_batch, nargs="+", default=[131072],
                    help="a batch capacity (the factor schedule) or a batch's exact level "
                         "rows joined by commas; several = the batches of one forward")
    ap.add_argument("--factor", type=float, default=0.5)
    ap.add_argument("--precision", choices=sorted(PEAK_FLOPS), default="bfloat16",
                    help="operand type: sets the item size and the FLOP peak")
    ap.add_argument("--measured-ms", type=float, default=None,
                    help="measured device ms of these batches (the bench's device_step_s)")
    args = ap.parse_args(argv)

    itemsize = ITEMSIZE[args.precision]
    for cap in args.capacity:
        caps, per_level, total = analyze(cap, factor=args.factor, itemsize=itemsize)
        print(f"batch {cap} (level rows {caps})")
        print(f"{'lvl':>3} {'cap':>8} {'gather idx':>12} {'MB moved':>10} {'MFLOP':>8}")
        for lv in per_level:
            print(f"{lv['level']:>3} {lv['cap']:>8} {lv['indices']:>12,} "
                  f"{lv['bytes'] / 1e6:>10.1f} {lv['flops'] / 1e6:>8.1f}")
        print(f"{'sum':>12} {total['indices']:>12,} {total['bytes'] / 1e6:>10.1f} "
              f"{total['flops'] / 1e6:>8.1f}")
    total = forward_totals(args.capacity, factor=args.factor, itemsize=itemsize)
    peak = PEAK_FLOPS[args.precision]
    print(f"\n{len(args.capacity)} batch(es): {total['indices']:,} gather indices "
          "(per-index cost on the H100: not measured)")
    print(f"bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s:      "
          f"{total['bytes'] / HBM_BYTES_PER_S * 1e3:10.4f} ms")
    print(f"FLOPs at {peak / 1e12:.0f} TFLOP/s ({args.precision}): "
          f"{total['flops'] / peak * 1e3:10.4f} ms")
    if args.measured_ms:
        a = achieved(total, args.measured_ms / 1e3, args.precision)
        print(f"measured: {args.measured_ms:.4f} ms")
        print(f"  -> achieved {a['flops_per_s'] / 1e9:10.2f} GFLOP/s "
              f"({100 * a['flop_share']:.4f}% of {peak / 1e12:.0f} TFLOP/s)")
        print(f"  -> achieved {a['bytes_per_s'] / 1e9:10.2f} GB/s "
              f"({100 * a['bytes_share']:.3f}% of {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
              "the gather + GEMM path's bytes)")


if __name__ == "__main__":
    main()
