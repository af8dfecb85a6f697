"""The window-attention kernel against its roofline in the SwinIR frames:
each launch's bound (srbench.yardstick_swinir: q k^T and P v, 2 x 64 x 64
x 30 useful multiply-adds each per window and head, against qkv read and A
written once and the bias table once; bytes bound it), summed over the
window's launches, over the kernel's summed device time, in %. Launches
and time are the trace's entries whose name carries the kernel's
anonymous-namespace mark; None where the program has no such kernel."""

MARK = "namespace)::window_attention_kernel"


def read(ctx):
    bound = ctx.get("window_attn_launch_bound_s")
    runs = [v for name, v in ctx["trace"].by_name.items() if MARK in name]
    launches = sum(n for n, _ in runs)
    spent = sum(s for _, s in runs)
    if bound is None or not launches or spent <= 0:
        return None
    return 100.0 * launches * bound / spent
