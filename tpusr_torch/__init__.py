"""tpusr_torch — the tpusr super-resolution system in PyTorch, for an NVIDIA H100.

A port of the JAX package ``tpusr`` (which stays the reference). Plain
tensor code is PyTorch; the Pallas kernels of ``tpusr`` become CUDA C++
kernels for sm_90a under ``tpusr_torch/csrc``. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
