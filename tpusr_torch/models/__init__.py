"""tpusr_torch.models."""
