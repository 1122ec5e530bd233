"""Plain PyTorch references the benchmark holds the program's outputs
against. Nothing here imports the program, JAX or the JAX package."""
