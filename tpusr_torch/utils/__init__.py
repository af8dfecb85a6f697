"""tpusr_torch.utils."""

from tpusr_torch.utils.convert import (chw_to_hwc, device_to_np, hwc_to_chw,
                                       np_to_device)

__all__ = ["chw_to_hwc", "hwc_to_chw", "np_to_device", "device_to_np"]
