"""PyTorch + CUDA port of the paged serving path (see README.md)."""
