"""``flash_attention``'s share of its roofline (%) in prefill: 4 D a live
pair for each (batch, q head) against the bf16 peak or the bytes at HBM's
rate, whichever bounds, over the device time of the operations launched
inside the range around its calls."""

from bench.flops import calls

WRAPS = {"flash_attention": ("repro_torch.kernels.flash_attn",
                             "flash_attention")}


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return calls.share(tr, "flash_attention", calls.attention, False)
