"""tpusr_torch.cli."""
