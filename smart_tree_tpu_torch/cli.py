"""`run-smart-tree-torch` CLI (counterpart of `smart_tree_tpu/cli.py`):

    run-smart-tree-torch +path=cloud.ply
    run-smart-tree-torch +directory=clouds/ pipeline.save_path=out/

Runs on the card. For the CPU:
    run-smart-tree-torch +path=cloud.ply pipeline.model_inference.device=cpu \
        pipeline.skeletonizer.device=cpu
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from .utils.configs import compose, default_conf_dir, instantiate


def main(argv=None) -> int:
    import logging

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    config = default_conf_dir() / "pipeline.yaml"
    # allow --config-path style override, hydra-ish
    overrides = []
    for a in argv:
        if a.startswith("--config="):
            config = Path(a.split("=", 1)[1])
        else:
            overrides.append(a)
    cfg = compose(config, overrides)
    if "path" not in cfg and "directory" not in cfg:
        print("Please supply a path or directory to point clouds "
              "(+path=... or +directory=...).")
        return 1
    pipeline = instantiate(cfg["pipeline"])
    if "path" in cfg:
        pipeline.process_cloud(Path(cfg["path"]))
    else:
        for p in sorted(os.listdir(cfg["directory"])):
            pipeline.process_cloud(Path(cfg["directory"]) / p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
