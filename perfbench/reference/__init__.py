"""Plain references the benchmark holds the program's outputs to: plain
PyTorch, importing nothing of the program."""
