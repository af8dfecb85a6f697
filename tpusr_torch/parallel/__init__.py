"""tpusr_torch.parallel."""
