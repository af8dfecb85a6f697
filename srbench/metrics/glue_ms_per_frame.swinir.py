"""Device ms per SwinIR frame of every operation that is neither one of
the port's kernels (A-E, the window-attention kernel) nor a cuDNN/cuBLAS
conv or GEMM: LayerNorms, GELU, residual adds, the weights' cast, the
nearest upsample, LeakyReLU, the mean and the crop."""

from srbench.tracing import is_glue

MARK = "namespace)::window_attention_kernel"


def read(ctx):
    tw = ctx["trace"]
    glue = sum(s for name, (_, s) in tw.by_name.items()
               if is_glue(name) and MARK not in name)
    return glue / tw.units * 1e3
