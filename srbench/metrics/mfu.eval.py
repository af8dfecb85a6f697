"""The generator's forward operations over the time of the untraced
images, as a share of the card's peak for the configuration's dtype, in
%."""


def read(ctx):
    if ctx["untraced_s"] <= 0:
        return None
    rate = ctx["untraced_flops"] / ctx["untraced_s"]
    return 100.0 * rate / ctx["peak_flops"]
