"""Tools run with `python3 -m smart_tree_tpu_torch.scripts.<name>`: the
measurement scripts (profile_*, compare_forward; card only) and the data
tools (split_data, bench_dataloader, vis_dataloader, laz2ply)."""
