"""tpusr_torch.engine."""
