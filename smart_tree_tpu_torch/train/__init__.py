"""Training: losses, plateau schedule, the train and eval steps, and the
`train-smart-tree-torch` entry point (train/train.py)."""
