"""Device ms per image-iteration of the lane batch of every operation that
is neither one of the port's kernels A-E nor a cuDNN/cuBLAS conv or GEMM
(the lanes' BatchNorms, activations, upsampling, padding, Adam)."""


def read(ctx):
    tw = ctx["trace"]
    return tw.glue_s() / (tw.units * ctx["unit_work"]) * 1e3
