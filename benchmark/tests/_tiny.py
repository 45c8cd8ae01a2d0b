"""A tiny checkout for the CPU tests: BENCHMARK.json's cells over small
trees (two of 400 points/m2), their configurations, limits and readers."""

import json
import shutil

from stbench import spec


def tiny_root(tmp_path, trees=2, density=400.0):
    root = tmp_path / "tiny"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for mix in {w["traffic"] for w in bench["workloads"]}:
        path = root / "benchmark/traffic" / f"{mix}.json"
        m = json.loads(path.read_text())
        m.update(trees=trees, tree_seed=5, points_per_m2=density, foliage_points=500,
                 trace_clouds=1, check_clouds=2)
        path.write_text(json.dumps(m))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
