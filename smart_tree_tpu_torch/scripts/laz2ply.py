"""LAZ / LAS -> PLY (counterpart of `smart_tree_tpu/scripts/laz2ply.py`).
Needs laspy, an optional dependency; without it the script says so and
exits 1.

    python -m smart_tree_tpu_torch.scripts.laz2ply in.laz out.ply
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    try:
        import laspy
    except ImportError:
        print("laz2ply requires laspy: pip install laspy[lazrs]")
        return 1

    las = laspy.read(args.src)
    xyz = np.stack([las.x, las.y, las.z], axis=1).astype(np.float32)
    if all(hasattr(las, c) for c in ("red", "green", "blue")):
        rgb = np.stack([las.red, las.green, las.blue], axis=1) / 65535.0
    else:
        rgb = np.zeros_like(xyz)
    from ..data.file import save_ply_cloud

    save_ply_cloud(args.dst, xyz, rgb)
    print(f"wrote {args.dst}: {len(xyz)} points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
