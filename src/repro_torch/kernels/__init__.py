"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``clg_stats``   wrappers of the three suff-stats kernels (``csrc/clg_stats.cu``)
``factor_ops``  wrappers of the four junction-tree factor kernels
                (``csrc/factor_ops.cu``)
``family_counts`` wrapper of the family-count kernel
                (``csrc/family_counts.cu``)
``flash_attn``  wrapper of the attention kernel (``csrc/flash_attn.cu``)
``ssd_scan``    wrapper of the Mamba2 SSD chunk-pass kernel
                (``csrc/ssd_scan.cu``)
``ref``         the plain PyTorch versions (CPU path and on-card yardstick)
``build``       nvcc build of ``csrc/`` into ctypes-loaded shared libraries
"""
