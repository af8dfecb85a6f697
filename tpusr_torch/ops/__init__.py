"""tpusr_torch.ops."""

from tpusr_torch.ops.bicubic import resize_bicubic, resize_matrix
from tpusr_torch.ops.degrade import (add_gaussian_noise,
                                     add_salt_pepper_noise, degrade_pipeline)
from tpusr_torch.ops.resample import (Downsampler, downsample_lanczos,
                                      get_kernel)

__all__ = [
    "Downsampler",
    "get_kernel",
    "downsample_lanczos",
    "resize_bicubic",
    "resize_matrix",
    "add_gaussian_noise",
    "add_salt_pepper_noise",
    "degrade_pipeline",
]
