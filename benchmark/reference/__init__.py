"""The plain reference the benchmark holds the program to: plain numpy,
scipy and PyTorch in float32, written from the published model and the
configuration. It imports nothing of the program, of the JAX package or of
JAX, and takes nothing the program made: the benchmark hands it the same
cloud and the same checkpoint file it hands the program."""
