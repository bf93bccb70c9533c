"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``clg_stats``   wrappers of the three suff-stats kernels (``csrc/clg_stats.cu``)
``factor_ops``  wrappers of the four junction-tree factor kernels
                (``csrc/factor_ops.cu``)
``ref``         the plain PyTorch versions (CPU path and on-card yardstick)
``build``       nvcc build of ``csrc/`` into ctypes-loaded shared libraries
"""
