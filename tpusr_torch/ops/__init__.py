"""tpusr_torch.ops."""
