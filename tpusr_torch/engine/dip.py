"""DIP engine — per-image Deep Image Prior super-resolution on the card.

Counterpart of ``tpusr/engine/dip.py`` (reference: DIP_ISR, DIP.py:22-123,
and utils/DIP.py). Semantics kept:
  * a fresh net with the torch init distribution and a fixed input: z =
    U(0,1) * input_noise_scale, or with input_method='meshgrid' the X and Y
    grids in [0, 1] (input_depth 2) (utils/DIP.py:79-101);
  * opt_over, a comma-set of net, input, down (utils/DIP.py:44-68): 'input'
    makes z a leaf, 'down' the full 2-D lanczos kernel, which the loss then
    applies through ``Downsampler.conv2d_with``; one optimizer covers every
    leaf;
  * each Adam iteration: z' = z + N(0,1) * reg_noise_std (DIP.py:51-52),
    the forward in train mode, lanczos2 downsample (phase 0.5,
    preserve_size), MSE against the LR image (DIP.py:60-65), backward, Adam
    (torch's Adam defaults equal optax's);
  * optimizer='lbfgs' (utils/DIP.py:19-31): 100 Adam warm-up steps at lr
    1e-3 with reg noise, then L-BFGS on a deterministic objective (no reg
    noise, batch statistics, running statistics frozen at their warm-up
    values): 'fixed' steps by lr with no line search (torch's LBFGS as the
    reference calls it), 'zoom' is optax.lbfgs with its zoom line search
    (engine/lbfgs.py);
  * shape buckets: with ``valid_hw`` the images are zero-padded
    bottom/right, the loss is the MSE over the valid LR region and the
    curves use the masked PSNR / SSIM;
  * PSNR/SSIM (and LPIPS when an ``lpips_fn`` is given) at each chunk head
    (iteration % log_freq == 0) on a forward with the clean z whose
    running-stat update is discarded;
  * the final image is net(z') with the LAST noisy draw of the Adam path
    (DIP.py:102) unless ``resolve_clean``; the L-BFGS path resolves clean.
The JAX package runs the loop as one jitted scan; here it is a Python loop
of PyTorch calls and kernel launches. The Adam path syncs nowhere inside
it; L-BFGS 'zoom' reads each trial's value and slope back.

The lane batch (``dip_superresolve_batch[_bucketed]``, tpusr's vmap) runs
N images' independent nets as one batched computation: the lanes'
parameters are stacked along a leading axis and ``torch.func.vmap`` runs
``functional_call`` of one template net over them (per-lane convs become
grouped convs), so one Adam over the stacked leaves is N per-lane Adams.
As in tpusr, it forces ``conv_fusion='off'``: no kernel runs there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from tpusr_torch.device import resolve_device
from tpusr_torch.engine.lbfgs import (ZoomLBFGS, lbfgs_fixed_init,
                                      lbfgs_fixed_step)
from tpusr_torch.engine.metrics import _valid_mask, psnr_masked, ssim_masked
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.models.skip import SkipNet, build_dip_net
from tpusr_torch.ops.resample import Downsampler

WARMUP_ITERS, WARMUP_LR = 100, 1e-3  # utils/DIP.py:19-24


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


def _opt_parts(config: DIPConfig) -> set[str]:
    """The parts of opt_over; unknown ones raise, as in the JAX package."""
    parts = {p.strip() for p in config.opt_over.split(",")}
    unknown = parts - {"net", "input", "down"}
    if unknown:
        raise ValueError(f"unknown opt_over parts {sorted(unknown)}")
    return parts


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


def meshgrid_input(h: int, w: int) -> torch.Tensor:
    """(1, h, w, 2) NHWC: X then Y, each linspace(0, 1) in f32 as the JAX
    package computes it (i * f32(1 / (n - 1)), the last entry exactly 1)."""
    def ramp(n):
        if n == 1:
            return torch.zeros(1)
        step = torch.tensor(1.0 / (n - 1), dtype=torch.float32)
        return torch.cat([torch.arange(n - 1, dtype=torch.float32) * step,
                          torch.ones(1)])

    xg = ramp(w)[None, None, :, None].expand(1, h, w, 1)
    yg = ramp(h)[None, :, None, None].expand(1, h, w, 1)
    return torch.cat([xg, yg], dim=-1)


def dip_loss(net, downsampler, z_iter, lr_image, kernel=None, lr_mask=None,
             update_stats: bool = True) -> torch.Tensor:
    """MSE between the downsampled net output and the LR image (NCHW),
    through ``conv2d_with(kernel)`` when a trained kernel is given, and over
    the valid region of ``lr_mask`` (1, 1, h, w) when one is given."""
    out = net(z_iter, update_stats=update_stats)
    out_lr = (downsampler(out) if kernel is None
              else downsampler.conv2d_with(out, kernel))
    err = (out_lr - lr_image).square()
    if lr_mask is None:
        return err.mean()
    count = torch.clamp(lr_mask.sum(), min=1.0) * err.shape[1]
    return (err * lr_mask).sum() / count


def dip_iteration(net, downsampler, optimizer, z, noise, lr_image,
                  reg_noise_std: float, kernel=None,
                  lr_mask=None) -> torch.Tensor:
    """One DIP step with the reg-noise draw given explicitly.

    z, noise: (1, C, H, W); lr_image: (1, 3, h, w). ``noise=None`` skips
    the perturbation. The optimizer holds every trained leaf (the net's
    parameters, and z and the kernel when they are trained). Returns the
    (detached) loss; no host sync.
    """
    z_iter = z if noise is None else z + noise * reg_noise_std
    loss = dip_loss(net, downsampler, z_iter, lr_image, kernel, lr_mask)
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


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def _assign(leaves, x: torch.Tensor) -> None:
    """Write the flat vector x into the leaves, in their order."""
    offset = 0
    for p in leaves:
        p.copy_(x[offset:offset + p.numel()].view(p.shape))
        offset += p.numel()


def flat_objective(net, downsampler, leaves, z, lr_image, kernel=None,
                   lr_mask=None):
    """L-BFGS's view of the DIP loss: (the leaves as one flat vector,
    value_and_grad(x) -> (loss, flat gradient)). value_and_grad writes x
    into the leaves, then evaluates the deterministic objective: no reg
    noise, batch statistics, running statistics untouched."""
    def value_and_grad(x):
        _assign(leaves, x)
        loss = dip_loss(net, downsampler, z, lr_image, kernel, lr_mask,
                        update_stats=False)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), _flat(grads)

    return _flat([t.detach() for t in leaves]), value_and_grad


def _check_input(config: DIPConfig) -> None:
    if config.input_method not in ("noise", "meshgrid"):
        raise ValueError(f"unknown input method {config.input_method!r}")
    if config.input_method == "meshgrid" and config.input_depth != 2:
        raise ValueError("meshgrid input requires input_depth=2")


def _chunks(config: DIPConfig) -> tuple[int, int, int]:
    """(chunks, iterations per chunk, remainder): one metrics head per
    log_freq iterations (one head when num_iter < log_freq)."""
    if config.num_iter >= config.log_freq:
        n_chunks, chunk_len = config.num_iter // config.log_freq, config.log_freq
    else:
        n_chunks, chunk_len = 1, config.num_iter
    return n_chunks, chunk_len, config.num_iter - n_chunks * chunk_len


def _head(out, hr, valid_hw, lpips_fn: Callable | None) -> list:
    """One chunk head's [PSNR, SSIM, LPIPS] of an NHWC estimate (masked
    to valid_hw when given; LPIPS NaN without lpips_fn)."""
    if valid_hw is None:
        m = [psnr_fn(out, hr), ssim_fn(out, hr, data_range=1.0)]
    else:
        m = [psnr_masked(out, hr, valid_hw), ssim_masked(out, hr, valid_hw)]
    m.append(lpips_fn(out, hr) if lpips_fn is not None
             else torch.full((), float("nan"), device=out.device))
    return m


def _dip_core(lr_image, hr_image, config: DIPConfig, generator, dev,
              lpips_fn: Callable | None, valid_hw=None):
    if config.optimizer not in ("adam", "lbfgs"):
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    if (config.optimizer == "lbfgs"
            and config.lbfgs_line_search not in ("fixed", "zoom")):
        raise ValueError(
            f"unknown lbfgs_line_search {config.lbfgs_line_search!r}")
    parts = _opt_parts(config)
    _check_input(config)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lr = _nchw(_image(lr_image, dev))
    hr = _image(hr_image, dev)
    _, h, w, _ = hr.shape

    net, downsampler = build(config, generator)
    net.to(dev, memory_format=torch.channels_last)
    downsampler.to(dev)
    dev_gen = torch.Generator(device=dev)
    dev_gen.manual_seed(int(torch.randint(0, 2 ** 62, (1,),
                                          generator=generator)))

    def draw(fn):  # NHWC draw, viewed as channels_last NCHW
        return _nchw(fn((1, h, w, config.input_depth), generator=dev_gen,
                        device=dev))

    if config.input_method == "noise":
        z = draw(torch.rand) * config.input_noise_scale
    else:
        z = _nchw(meshgrid_input(h, w).to(dev).contiguous())

    leaves = list(net.parameters())
    if "input" in parts:
        z = z.detach().clone().requires_grad_()
        leaves.append(z)
    kernel = None
    if "down" in parts:
        kernel = downsampler.kernel.detach().clone().requires_grad_()
        leaves.append(kernel)

    lr_mask = None
    if valid_hw is not None:
        lr_valid = (valid_hw[0] // config.factor, valid_hw[1] // config.factor)
        lr_mask = _valid_mask(lr.shape[2:4], lr_valid, dev)
        lr_mask = lr_mask[..., 0][None, None]  # (1, 1, h, w)

    def metrics_of():
        with torch.no_grad():
            return _head(net(z, update_stats=False).permute(0, 2, 3, 1), hr,
                         valid_hw, lpips_fn)

    n_chunks, chunk_len, remainder = _chunks(config)
    std = config.reg_noise_std
    noise = None

    def adam_run(optimizer, n_iter):
        nonlocal noise
        loss = torch.full((), float("nan"), device=dev)
        for _ in range(n_iter):
            noise = draw(torch.randn) if std > 0 else None
            loss = dip_iteration(net, downsampler, optimizer, z, noise, lr,
                                 std, kernel, lr_mask)
        return loss

    heads, losses, evals = [], [], []
    if config.optimizer == "adam":
        optimizer = torch.optim.Adam(leaves, lr=config.learning_rate)

        def run(n_iter):
            evals.append(n_iter)
            return adam_run(optimizer, n_iter)
    else:
        adam_run(torch.optim.Adam(leaves, lr=WARMUP_LR), WARMUP_ITERS)
        noise = None  # the L-BFGS stage and its resolve are noise-free
        x, value_and_grad = flat_objective(net, downsampler, leaves, z, lr,
                                           kernel, lr_mask)
        if config.lbfgs_line_search == "fixed":
            state = lbfgs_fixed_init(x.numel(), config.lbfgs_memory, dev)

            def lbfgs_iter(p):
                nonlocal state
                value, g = value_and_grad(p)
                upd, state = lbfgs_fixed_step(g, state,
                                              config.learning_rate)
                return p + upd.to(p.dtype), value, 1
        else:
            zoom = ZoomLBFGS(x.numel(), config.lbfgs_memory, dev, x.dtype)

            def lbfgs_iter(p):
                before = zoom.evals
                p, value = zoom.step(p, value_and_grad)
                return p, value, zoom.evals - before

        def run(n_iter):
            nonlocal x
            value, n_evals = float("nan"), 0
            for _ in range(n_iter):
                x, value, k = lbfgs_iter(x)
                n_evals += k
            _assign(leaves, x)
            evals.append(n_evals)
            return torch.as_tensor(value, dtype=torch.float32, device=dev)

    for _ in range(n_chunks):
        heads.append(metrics_of())  # chunk head == iteration % log_freq == 0
        losses.append(run(chunk_len))
    run(remainder)
    rem = evals.pop()
    evals[-1] += rem  # the remainder counts in the last chunk

    z_final = z
    if not config.resolve_clean and noise is not None:
        z_final = z + noise * std
    with torch.no_grad():
        resolved = net(z_final, update_stats=False).permute(0, 2, 3, 1)
    cols = [torch.stack(c).float().cpu().numpy() for c in zip(*heads)]
    curves = {"psnr": cols[0], "ssim": cols[1], "lpips": cols[2],
              "loss": torch.stack(losses).float().cpu().numpy(),
              "evals": np.asarray(evals, np.int64)}
    return resolved.contiguous(), curves


def dip_superresolve(lr_image, hr_image, config: DIPConfig,
                     generator: torch.Generator | None = None,
                     device: str | torch.device = "cuda",
                     lpips_fn: Callable | None = None):
    """Super-resolve one image with DIP.

    Args:
      lr_image: (1, h, w, 3) uint8 or float [0,1] (numpy or tensor)
      hr_image: (1, H, W, 3) with H = factor*h — ground truth, used only
        for the metric curves, as in the reference
      config: hyperparameters
      generator: CPU torch.Generator for the net init; it also seeds the
        device generator that draws z and the reg noise (default seed 0)
      device: 'cuda' (default) or 'cpu'
      lpips_fn: optional LPIPS(pred, target) over NHWC images; the LPIPS
        curve is NaN without one

    Returns:
      resolved: (1, H, W, 3) f32 tensor on ``device``
      curves: dict of numpy arrays 'psnr'/'ssim'/'lpips'/'loss' of length
        num_iter // log_freq (1 when num_iter < log_freq), and 'evals', the
        objective gradients each chunk evaluated (its L-BFGS trial points
        included, the warm-up not)
    """
    return _dip_core(lr_image, hr_image, config, generator,
                     resolve_device(device), lpips_fn)


def dip_superresolve_bucketed(lr_image, hr_image, valid_hw,
                              config: DIPConfig,
                              generator: torch.Generator | None = None,
                              device: str | torch.device = "cuda",
                              lpips_fn: Callable | None = None):
    """Shape-bucketed single-image DIP.

    lr/hr are zero-padded (bottom/right) to a bucket size; valid_hw is the
    true (H, W) of the HR image. The loss and the curves are masked to the
    valid region; the caller crops the returned (padded) image to valid_hw.
    """
    valid = (int(valid_hw[0]), int(valid_hw[1]))
    return _dip_core(lr_image, hr_image, config, generator,
                     resolve_device(device), lpips_fn, valid_hw=valid)


def dip_superresolve_scan_bucketed(lr_images, hr_images, valid_hws,
                                   generators, config: DIPConfig,
                                   device: str | torch.device = "cuda",
                                   lpips_fn: Callable | None = None):
    """Bucketed DIP over a group of images, one after another on the card,
    a fresh net per image from its own generator (the JAX package maps the
    group with lax.map). lr_images (N, 1, h, w, 3), hr_images
    (N, 1, H, W, 3), valid_hws (N, 2), N generators. Returns the stacked
    resolved images (N, 1, H, W, 3) and curves with a leading N axis."""
    out, curves = [], []
    for lr_i, hr_i, v, gen in zip(lr_images, hr_images, valid_hws,
                                  generators):
        res, c = dip_superresolve_bucketed(lr_i, hr_i, v, config, gen,
                                           device, lpips_fn)
        out.append(res)
        curves.append(c)
    return torch.stack(out), {k: np.stack([c[k] for c in curves])
                              for k in curves[0]}


def stack_lanes(nets, device) -> dict[str, torch.Tensor]:
    """The lanes' parameters, each stacked along a new leading axis, as
    trainable leaves on ``device`` (one template net's names)."""
    named = [dict(net.named_parameters()) for net in nets]
    return {k: torch.stack([p[k].detach().to(device) for p in named])
            .requires_grad_() for k in named[0]}


def _lane_out(template, p, z_lane):
    from torch.func import functional_call

    # train-mode statistics; the running-statistics update is skipped
    # (vmap refuses its in-place write, and DIP never reads it)
    return functional_call(template, p, (z_lane,), {"update_stats": False})


def _lane_loss(template, downsampler, p, z_lane, lr_lane, k_lane, m_lane):
    """``dip_loss`` of one lane, for vmap."""
    out = _lane_out(template, p, z_lane)
    out_lr = (downsampler(out) if k_lane is None
              else downsampler.conv2d_with(out, k_lane))
    err = (out_lr - lr_lane).square()
    if m_lane is None:
        return err.mean()
    count = torch.clamp(m_lane.sum(), min=1.0) * err.shape[1]
    return (err * m_lane).sum() / count


def lane_iteration(template, downsampler, params, optimizer, z, noise,
                   lr_images, reg_noise_std: float, kernel=None,
                   lr_mask=None) -> torch.Tensor:
    """One DIP step of every lane at once (``dip_iteration`` per lane).

    params: stacked leaves (``stack_lanes``) that ``template`` is called
    with; z, noise (N, 1, C, H, W) (noise None skips the perturbation);
    lr_images (N, 1, 3, h, w); kernel (N, k, k) and lr_mask
    (N, 1, 1, h, w) when trained or bucketed. ``optimizer`` holds the
    stacked leaves (and z, kernel when trained): Adam is elementwise with
    one step count, so one Adam over them is N per-lane Adams. Returns the
    lanes' losses (N,), detached; no host sync.
    """
    from torch.func import vmap

    loss_fn = vmap(functools.partial(_lane_loss, template, downsampler),
                   in_dims=(0, 0, 0, None if kernel is None else 0,
                            None if lr_mask is None else 0))
    z_iter = z if noise is None else z + noise * reg_noise_std
    losses = loss_fn(params, z_iter, lr_images, kernel, lr_mask)
    optimizer.zero_grad(set_to_none=True)
    # lanes share no leaf, so the sum's gradient is each lane's own
    losses.sum().backward()
    optimizer.step()
    return losses.detach()


def _lane_core(lr_images, hr_images, config: DIPConfig, generators, dev,
               lpips_fn: Callable | None, valid_hws=None):
    """N lanes of ``_dip_core``'s Adam path as one batched computation.

    Lane i is the single-image run with ``generators[i]``: its net is
    initialised from it, and the device generator it seeds draws the lane's
    z and reg noise, drawn per lane outside vmap and stacked (vmap's own
    randomness would not reproduce a lane's stream). The forward is
    train-mode with the running-statistics update skipped: vmap refuses
    BatchNorm's in-place update, and no DIP forward ever reads those
    statistics (every one normalises with its batch's).
    """
    from torch.func import vmap

    if config.optimizer != "adam":
        raise ValueError(
            f"the lane batch runs Adam; optimizer {config.optimizer!r} runs "
            f"one image at a time (dip_superresolve_scan_bucketed)")
    parts = _opt_parts(config)
    _check_input(config)
    config = dataclasses.replace(config, conv_fusion="off")
    n = len(generators)
    if not (len(lr_images) == len(hr_images) == n):
        raise ValueError("lr_images, hr_images and generators differ in "
                         "length")
    lr = torch.stack([_nchw(_image(a, dev)) for a in lr_images])
    hr = torch.stack([_image(a, dev) for a in hr_images])  # (N, 1, H, W, 3)
    _, _, h, w, _ = hr.shape

    nets, dev_gens = [], []
    for gen in generators:
        net, downsampler = build(config, gen)
        nets.append(net)
        dg = torch.Generator(device=dev)
        dg.manual_seed(int(torch.randint(0, 2 ** 62, (1,), generator=gen)))
        dev_gens.append(dg)
    template = nets[0].to(dev)
    downsampler.to(dev)

    def draw(fn):  # one NHWC draw per lane, stacked as (N, 1, C, H, W)
        return torch.stack([_nchw(fn((1, h, w, config.input_depth),
                                     generator=g, device=dev))
                            for g in dev_gens])

    if config.input_method == "noise":
        z = draw(torch.rand) * config.input_noise_scale
    else:
        z = _nchw(meshgrid_input(h, w).to(dev))[None].expand(
            n, -1, -1, -1, -1).contiguous()
    params = stack_lanes(nets, dev)
    leaves = list(params.values())
    if "input" in parts:
        z = z.detach().clone().requires_grad_()
        leaves.append(z)
    kernel = None
    if "down" in parts:
        kernel = downsampler.kernel.detach()[None].repeat(n, 1, 1)
        kernel.requires_grad_()
        leaves.append(kernel)

    lr_mask = None
    if valid_hws is not None:
        lr_mask = torch.stack([
            _valid_mask(lr.shape[-2:], (int(v[0]) // config.factor,
                                        int(v[1]) // config.factor),
                        dev)[..., 0][None, None] for v in valid_hws])
    batched_out = vmap(functools.partial(_lane_out, template))

    def forward_nhwc(z_in):  # (N, 1, H, W, 3)
        return batched_out(params, z_in).permute(0, 1, 3, 4, 2)

    def metrics_of():  # (N, 3)
        with torch.no_grad():
            out = forward_nhwc(z)
            return torch.stack([torch.stack(_head(
                out[i], hr[i], None if valid_hws is None else
                (int(valid_hws[i][0]), int(valid_hws[i][1])), lpips_fn))
                for i in range(n)])

    n_chunks, chunk_len, remainder = _chunks(config)
    std = config.reg_noise_std
    optimizer = torch.optim.Adam(leaves, lr=config.learning_rate)
    noise = None

    def run(n_iter):
        nonlocal noise
        losses = torch.full((n,), float("nan"), device=dev)
        for _ in range(n_iter):
            noise = draw(torch.randn) if std > 0 else None
            losses = lane_iteration(template, downsampler, params,
                                    optimizer, z, noise, lr, std, kernel,
                                    lr_mask)
        return losses

    heads, losses = [], []
    for _ in range(n_chunks):
        heads.append(metrics_of())
        losses.append(run(chunk_len))
    run(remainder)

    z_final = z
    if not config.resolve_clean and noise is not None:
        z_final = z + noise * std
    with torch.no_grad():
        resolved = forward_nhwc(z_final).contiguous()
    m = torch.stack(heads, 1).float().cpu().numpy()  # (N, chunks, 3)
    evals = [chunk_len] * n_chunks
    evals[-1] += remainder
    curves = {"psnr": m[..., 0], "ssim": m[..., 1], "lpips": m[..., 2],
              "loss": torch.stack(losses, 1).float().cpu().numpy(),
              "evals": np.tile(np.asarray(evals, np.int64), (n, 1))}
    return resolved, curves


def dip_superresolve_batch(lr_images, hr_images,
                           generators: Sequence[torch.Generator],
                           config: DIPConfig,
                           device: str | torch.device = "cuda",
                           lpips_fn: Callable | None = None):
    """Multi-image DIP as one batched computation (tpusr's vmap).

    lr_images (N, 1, h, w, 3), hr_images (N, 1, H, W, 3), N generators:
    each lane optimises a fresh net of its own, as ``dip_superresolve``
    with that generator and conv_fusion 'off' would. Adam only (L-BFGS
    lanes run one at a time, ``dip_superresolve_scan_bucketed``). Returns
    (N, 1, H, W, 3) and curves with a leading N axis.
    """
    return _lane_core(lr_images, hr_images, config, list(generators),
                      resolve_device(device), lpips_fn)


def dip_superresolve_batch_bucketed(lr_images, hr_images, valid_hws,
                                    generators: Sequence[torch.Generator],
                                    config: DIPConfig,
                                    device: str | torch.device = "cuda",
                                    lpips_fn: Callable | None = None):
    """The lane batch over images zero-padded to one bucket; valid_hws
    (N, 2) the true HR sizes: each lane's loss and curves are masked to
    its own valid region (``dip_superresolve_bucketed`` per lane)."""
    return _lane_core(lr_images, hr_images, config, list(generators),
                      resolve_device(device), lpips_fn,
                      valid_hws=np.asarray(valid_hws))


def pad_to_bucket(arr, bucket: int):
    """Pad NHWC (or HWC) bottom/right with zeros to multiples of bucket.

    Returns (padded, (h, w)) with the original spatial size.
    """
    h, w = arr.shape[-3], arr.shape[-2]
    ph, pw = (-h) % bucket, (-w) % bucket
    if ph == 0 and pw == 0:
        return arr, (h, w)
    pad = [(0, 0)] * arr.ndim
    pad[-3] = (0, ph)
    pad[-2] = (0, pw)
    return np.pad(np.asarray(arr), pad), (h, w)
