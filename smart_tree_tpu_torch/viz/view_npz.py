"""`view-npz-torch`: inspect synthetic-trees npz files (counterpart of
`smart_tree_tpu/viz/view_npz.py`). Prints a summary per file, can export
the cloud as PLY, and with open3d installed opens the viewer.

    view-npz-torch tree.npz [more.npz ...] [--export-ply out.ply]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.file import load_data_npz, save_ply_cloud
from .viewer import HAVE_O3D, view_cloud


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--export-ply", type=Path, default=None)
    args = ap.parse_args(argv)

    for p in args.paths:
        cloud, skeleton = load_data_npz(p)
        print(f"{p}: {len(cloud)} points", end="")
        if cloud.class_l is not None:
            counts = np.bincount(np.asarray(cloud.class_l).reshape(-1).astype(int))
            print(f", classes {counts.tolist()}", end="")
        if skeleton is not None:
            print(f", skeleton: {len(skeleton.branches)} branches", end="")
        print()
        if args.export_ply:
            save_ply_cloud(args.export_ply, np.asarray(cloud.xyz),
                           np.asarray(cloud.rgb) if cloud.rgb is not None else None)
            print(f"  wrote {args.export_ply}")
        if HAVE_O3D:
            view_cloud(cloud)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
