"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and plain
PyTorch versions, and the torch-side sort-key packing. Kernels build at
first use, never at import."""
