"""The benchmark of the PyTorch / CUDA port; see README.md."""
