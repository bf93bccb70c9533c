"""The attention backward's share of its roofline (%): the calls of
``flash_attention_backward`` (the gradient ``FlashAttentionFn`` takes),
10 D a live pair for each (batch, q head) against the bf16 peak or the
bytes at HBM's rate, whichever bounds, over the device time of the
operations launched inside the range around them."""

from bench.flops import calls

WRAPS = {"flash_attention_backward": ("repro_torch.kernels.flash_attn",
                                      "flash_attention_backward")}


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return calls.share(tr, "flash_attention_backward", calls.attention, True)
