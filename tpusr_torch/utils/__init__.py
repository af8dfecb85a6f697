"""tpusr_torch.utils."""
