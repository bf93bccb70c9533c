"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``clg_stats``   wrappers of the three suff-stats kernels (``csrc/clg_stats.cu``)
``ref``         the plain PyTorch versions (CPU path and on-card yardstick)
``build``       nvcc build of ``csrc/`` into a ctypes-loaded shared library
"""
