"""Measurement scripts run on the card (`python3 -m smart_tree_tpu_torch.scripts.<name>`)."""
