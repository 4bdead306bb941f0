"""The port's kernels: plain PyTorch versions beside hand-written Hopper
kernels (csrc/), built by nvcc on first use (_build.py)."""
