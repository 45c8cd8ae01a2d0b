"""The repository's user tools, ported: each runs as
`python -m smart_tree_tpu_torch.tools.<name>` with the arguments of the JAX
tool of the same file name under `tools/`, and imports no JAX.

  make_synthetic_dataset  tools/make_synthetic_dataset.py  host only
  convert_checkpoint      tools/convert_checkpoint.py      host only
  evaluate                tools/evaluate.py                `--device` for `--cpu`
  diagnose_direction      tools/diagnose_direction.py      `--device`
  diagnose_e2e            tools/diagnose_e2e.py            `--device`
  bench_scan              tools/bench_scan.py              `--device`
  overfit_probe           tools/overfit_probe.py           `--device`
  cpu_probe               tools/cpu_probe.py               `--device` (the card by default)

The tools with `--device` run on the card unless it names another device,
and raise without a card; the two host tools touch no device.
"""
