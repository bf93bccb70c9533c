"""Device ms a step of the blocks' own work around the products and the
hand kernels (norms, RoPE, activations, the Mamba2 convolution, gate and
norm, casts, the loss): every device operation that is neither a cuBLAS
product (a kernel named as cuBLAS names its own), nor launched inside the
hand kernels' wrappers' ranges, nor inside the optimizer's.  Absent where
an operation could not be tied to the call that launched it."""

MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
WRAPS = {"flash_attention": ("repro_torch.kernels.flash_attn",
                             "flash_attention"),
         "flash_attention_backward": ("repro_torch.kernels.flash_attn",
                                      "flash_attention_backward"),
         "ssd_scan": ("repro_torch.kernels.ssd_scan", "ssd_scan"),
         "ssd_scan_backward": ("repro_torch.kernels.ssd_scan",
                               "ssd_scan_backward"),
         "adamw_update": ("repro_torch.train.optimizer", "adamw_update"),
         "vb_update": ("repro_torch.bayes.vb_optimizer", "vb_update")}


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.unmatched:
        return None
    ns = sum(op.dur_ns for op in tr.ops
             if op.span is None
             and not any(f in op.name.lower() for f in MATMUL_NAMES))
    return ns / 1e6 / tr.units
