"""DIP engine — per-image Deep Image Prior super-resolution on the card.

Counterpart of ``tpusr/engine/dip.py`` (reference: DIP_ISR, DIP.py:22-123,
and the Adam loop of utils/DIP.py:33-40) for optimizer='adam',
input_method='noise', opt_over='net'. Semantics kept:
  * a fresh net with the torch init distribution and a fixed input
    z = U(0,1) * input_noise_scale (utils/DIP.py:79-96);
  * each iteration: z' = z + N(0,1) * reg_noise_std (DIP.py:51-52), the
    forward in train mode, lanczos2 downsample (phase 0.5, preserve_size),
    MSE against the LR image (DIP.py:60-65), backward, Adam(lr) over the
    net's parameters (torch's Adam defaults equal optax's);
  * PSNR/SSIM at each chunk head (iteration % log_freq == 0) on a forward
    with the CLEAN z whose running-stat update is discarded;
  * the final image is net(z') with the LAST noisy draw (DIP.py:102)
    unless ``resolve_clean``.
The JAX package runs the loop as one jitted scan; here it is a Python loop
of PyTorch calls and kernel launches, with no host sync inside it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpusr_torch.device import resolve_device
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.models.skip import SkipNet, build_dip_net
from tpusr_torch.ops.resample import Downsampler


@dataclasses.dataclass(frozen=True)
class DIPConfig:
    """DIP.py main() defaults (DIP.py:169-174, 318-336); same fields as the
    JAX package's DIPConfig."""

    factor: int = 8
    num_iter: int = 1000
    learning_rate: float = 0.01
    reg_noise_std: float = 0.05
    log_freq: int = 100
    input_depth: int = 32
    input_noise_scale: float = 0.1
    pad: str = "reflection"
    upsample_mode: str = "bilinear"
    skip_n33d: int = 128
    skip_n33u: int = 128
    skip_n11: int = 4
    num_scales: int = 5
    dtype: str = "float32"
    optimizer: str = "adam"
    input_method: str = "noise"
    opt_over: str = "net"
    lbfgs_memory: int = 10
    lbfgs_line_search: str = "zoom"
    resolve_clean: bool = False
    conv_fusion: str = "auto"


def check_ported(config: DIPConfig) -> None:
    """Raise for the DIP variants this package does not run yet."""
    waiting = []
    if config.optimizer != "adam":
        waiting.append(f"optimizer={config.optimizer!r}")
    if config.input_method != "noise":
        waiting.append(f"input_method={config.input_method!r}")
    if {p.strip() for p in config.opt_over.split(",")} != {"net"}:
        waiting.append(f"opt_over={config.opt_over!r}")
    if waiting:
        raise NotImplementedError(
            f"not yet ported to tpusr_torch: {', '.join(waiting)}")


def build(config: DIPConfig, generator: torch.Generator | None = None
          ) -> tuple[SkipNet, Downsampler]:
    """The net (initialized from ``generator``) and the loss operator."""
    net = build_dip_net(
        input_depth=config.input_depth, pad=config.pad,
        upsample_mode=config.upsample_mode, skip_n33d=config.skip_n33d,
        skip_n33u=config.skip_n33u, skip_n11=config.skip_n11,
        num_scales=config.num_scales,
        dtype=None if config.dtype == "float32" else config.dtype,
        conv_fusion=config.conv_fusion, generator=generator)
    downsampler = Downsampler(n_planes=3, factor=config.factor,
                              kernel_type="lanczos2", phase=0.5,
                              preserve_size=True)  # DIP.py:29
    return net, downsampler


def make_optimizer(net: torch.nn.Module, config: DIPConfig):
    return torch.optim.Adam(net.parameters(), lr=config.learning_rate)


def dip_iteration(net, downsampler, optimizer, z, noise, lr_image,
                  reg_noise_std: float) -> torch.Tensor:
    """One DIP step with the reg-noise draw given explicitly.

    z, noise: (1, C, H, W); lr_image: (1, 3, h, w). ``noise=None`` skips
    the perturbation. Returns the (detached) loss; no host sync.
    """
    z_iter = z if noise is None else z + noise * reg_noise_std
    out_lr = downsampler(net(z_iter))
    loss = (out_lr - lr_image).square().mean()
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _image(a, dev) -> torch.Tensor:
    """(1, H, W, 3) numpy/tensor, uint8 or float in [0, 1] -> f32 NHWC."""
    t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    if t.dim() == 3:
        t = t[None]
    t = t.to(dev)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def dip_superresolve(lr_image, hr_image, config: DIPConfig,
                     generator: torch.Generator | None = None,
                     device: str | torch.device = "cuda"):
    """Super-resolve one image with DIP.

    Args:
      lr_image: (1, h, w, 3) uint8 or float [0,1] (numpy or tensor)
      hr_image: (1, H, W, 3) with H = factor*h — ground truth, used only
        for the metric curves, as in the reference
      config: hyperparameters
      generator: CPU torch.Generator for the net init; it also seeds the
        device generator that draws z and the reg noise (default seed 0)
      device: 'cuda' (default) or 'cpu'

    Returns:
      resolved: (1, H, W, 3) f32 tensor on ``device``
      curves: dict of numpy arrays 'psnr'/'ssim'/'lpips'/'loss' of length
        num_iter // log_freq (1 when num_iter < log_freq); lpips is NaN
    """
    check_ported(config)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lr = _nchw(_image(lr_image, dev))
    hr = _image(hr_image, dev)
    _, h, w, _ = hr.shape

    net, downsampler = build(config, generator)
    net.to(dev, memory_format=torch.channels_last)
    downsampler.to(dev)
    optimizer = make_optimizer(net, config)
    dev_gen = torch.Generator(device=dev)
    dev_gen.manual_seed(int(torch.randint(0, 2 ** 62, (1,),
                                          generator=generator)))

    def draw(fn):  # NHWC draw, viewed as channels_last NCHW
        return _nchw(fn((1, h, w, config.input_depth), generator=dev_gen,
                        device=dev))

    z = draw(torch.rand) * config.input_noise_scale
    std = config.reg_noise_std

    def metrics_of():
        with torch.no_grad():
            out = net(z, update_stats=False).permute(0, 2, 3, 1)
        return psnr_fn(out, hr), ssim_fn(out, hr, data_range=1.0)

    if config.num_iter >= config.log_freq:
        n_chunks, chunk_len = config.num_iter // config.log_freq, config.log_freq
    else:
        n_chunks, chunk_len = 1, config.num_iter
    remainder = config.num_iter - n_chunks * chunk_len

    psnrs, ssims, losses = [], [], []
    noise = None

    def run(n_iter):
        nonlocal noise
        loss = torch.full((), float("nan"), device=dev)
        for _ in range(n_iter):
            noise = draw(torch.randn) if std > 0 else None
            loss = dip_iteration(net, downsampler, optimizer, z, noise, lr,
                                 std)
        return loss

    for _ in range(n_chunks):
        p, s = metrics_of()  # chunk head == iteration % log_freq == 0
        psnrs.append(p)
        ssims.append(s)
        losses.append(run(chunk_len))
    run(remainder)

    z_final = z
    if not config.resolve_clean and noise is not None:
        z_final = z + noise * std
    with torch.no_grad():
        resolved = net(z_final, update_stats=False).permute(0, 2, 3, 1)
    curves = {"psnr": torch.stack(psnrs).cpu().numpy(),
              "ssim": torch.stack(ssims).cpu().numpy(),
              "lpips": np.full(n_chunks, np.nan, np.float32),
              "loss": torch.stack(losses).cpu().numpy()}
    return resolved.contiguous(), curves
