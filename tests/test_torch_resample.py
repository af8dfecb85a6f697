"""tpusr_torch resampling kernels and Downsampler against the JAX package's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpusr.ops import resample as jr
from tpusr_torch.ops import resample as tr

SPECS = [(8, "lanczos2", 0.5), (4, "lanczos2", 0.5), (4, "lanczos3", 0.0),
         (2, "gauss12", 0.0), (2, "gauss1sq2", 0.0)]


@pytest.mark.parametrize("factor,name,phase", SPECS)
def test_kernels_equal_jax_exactly(factor, name, phase):
    spec = tr.resolve_kernel_spec(factor, name)
    assert spec == jr.resolve_kernel_spec(factor, name)
    ktype, width, support, sigma = spec
    np.testing.assert_array_equal(
        tr.get_kernel(factor, ktype, phase, width, support, sigma),
        jr.get_kernel(factor, ktype, phase, width, support, sigma))
    port = tr.Downsampler(3, factor, name, phase=phase, preserve_size=True)
    ref = jr.Downsampler(3, factor, name, phase=phase, preserve_size=True)
    np.testing.assert_array_equal(port.taps.numpy(), ref.taps)
    assert port.pad == ref.pad


@pytest.mark.parametrize("factor,hw", [(8, (64, 64)), (4, (40, 56))])
def test_downsampler_matches_jax(factor, hw):
    """The DIP loss operator (lanczos2, phase 0.5, preserve_size): forward
    and adjoint (the JAX custom VJP against torch autograd)."""
    rng = np.random.default_rng(factor)
    x = rng.random((1, *hw, 3)).astype(np.float32)
    port = tr.Downsampler(3, factor, "lanczos2", phase=0.5,
                          preserve_size=True)
    ref = jr.Downsampler(3, factor, "lanczos2", phase=0.5,
                         preserve_size=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = port(xt)
    yj = ref(jnp.asarray(x))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(yj), atol=1e-6)
    g = rng.standard_normal(yj.shape).astype(np.float32)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    gj = jax.grad(lambda a: jnp.sum(ref(a) * g))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gj), atol=1e-6)
