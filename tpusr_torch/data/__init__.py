"""tpusr_torch.data."""
