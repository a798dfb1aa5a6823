"""PyTorch / CUDA port of the Dora substrate (see README.md)."""
