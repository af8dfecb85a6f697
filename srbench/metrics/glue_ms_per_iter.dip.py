"""Device ms per image-iteration (a lane-batch iteration counts its
lanes) of every operation that is neither one of the port's kernels A-E
nor a cuDNN/cuBLAS conv or GEMM: BatchNorm reductions and affines,
activations, upsampling, padding, Adam, casts, copies."""


def read(ctx):
    tw = ctx["trace"]
    return tw.glue_s() / (tw.units * ctx["unit_work"]) * 1e3
