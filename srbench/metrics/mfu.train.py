"""The model operations of the untraced steps (G forward and backward, D
forward and backward on real and fake, D forward and input gradients for
G's update, VGG19 on prediction and target with its input gradients;
nothing recomputed counted) over their time, as a share of the card's
peak for the cell's dtype, in %."""


def read(ctx):
    if ctx["untraced_s"] <= 0:
        return None
    rate = ctx["untraced_flops"] / ctx["untraced_s"]
    return 100.0 * rate / ctx["peak_flops"]
