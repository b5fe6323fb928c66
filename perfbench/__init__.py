"""The benchmark of the PyTorch and CUDA port (``perfbench/run.py``)."""
