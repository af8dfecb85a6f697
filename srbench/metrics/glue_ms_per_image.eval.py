"""Device ms per eval image of every operation that is neither one of the
port's kernels A-E nor a cuDNN/cuBLAS conv or GEMM: BatchNorm affines,
PReLU, residual adds, pixel shuffle copies, tanh, casts."""


def read(ctx):
    tw = ctx["trace"]
    return tw.glue_s() / tw.units * 1e3
