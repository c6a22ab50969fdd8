"""Hand-written CUDA kernels (csrc/) and their build (build.py)."""
