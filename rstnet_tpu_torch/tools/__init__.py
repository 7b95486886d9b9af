"""Command-line tools for the PyTorch/CUDA port."""
