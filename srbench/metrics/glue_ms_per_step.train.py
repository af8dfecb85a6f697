"""Device ms per training step of every operation that is neither one of
the port's kernels A-E nor a cuDNN/cuBLAS conv or GEMM: BatchNorm, PReLU,
LeakyReLU, the losses, VGG's resize, both Adams (D's bf16 one in about 400
launches), casts, crops."""


def read(ctx):
    tw = ctx["trace"]
    return tw.glue_s() / tw.units * 1e3
