"""tpusr_torch.io."""
