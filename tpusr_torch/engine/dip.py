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
The JAX package runs the loop as one jitted scan, and its batch as
jax.vmap of that one core. Here one core, ``_dip_core``, runs the loop
over N lanes as Python calls and kernel launches, N = 1 for a single
image. What differs between one net and N lanes sits behind one seam:
  * ``_SingleNet`` (one image): one net in channels_last. On a card each
    Adam stage replays its iterations' forward and backward as one CUDA
    graph after two eager iterations, with Adam eager after each
    (``_AdamStage``).
  * ``_LaneSet`` (``dip_superresolve_batch[_bucketed]``, tpusr's vmap):
    the lanes' parameters stacked along a leading axis and
    ``torch.func.vmap`` over ``functional_call`` of one template net
    (per-lane convs become grouped convs); one Adam over the stacked leaves
    is N per-lane Adams. As in tpusr it forces ``conv_fusion='off'``: no
    kernel runs there.
L-BFGS runs over the lanes' (N, n) stack of flat vectors
(``flat_objective`` for one net, ``lane_objective`` for lanes) with
engine/lbfgs.py's lane steppers; the zoom line search is one host-side
state machine per lane, driving one batched value-and-gradient call per
round. The Adam path syncs nowhere inside it; L-BFGS 'zoom' reads each
trial's value and slope back. A call, its net build, heads, iterations and
resolve are spans (utils/profiling.py), each iteration's opened by the
loop that runs it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from tpusr_torch.device import resolve_device
from tpusr_torch.engine.lbfgs import (ZoomLBFGSLanes, lbfgs_fixed_init_lanes,
                                      lbfgs_fixed_step_lanes, one_lane)
from tpusr_torch.engine.metrics import _valid_mask, psnr_masked, ssim_masked
from tpusr_torch.engine.metrics import psnr as psnr_fn
from tpusr_torch.engine.metrics import ssim as ssim_fn
from tpusr_torch.models.skip import SkipNet, build_dip_net
from tpusr_torch.ops import bn_act, fused_conv
from tpusr_torch.ops.resample import Downsampler
from tpusr_torch.utils.profiling import span

WARMUP_ITERS, WARMUP_LR = 100, 1e-3  # utils/DIP.py:19-24
EAGER_ITERS = 2  # eager Adam iterations of a stage before its CUDA graph


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
    the valid region of ``lr_mask`` (1, 1, h, w) when one is given. ``net``
    is called as net(z_iter, update_stats=...): a net, or one lane's
    forward under vmap (``_lane_loss``)."""
    out = net(z_iter, update_stats=update_stats)
    out_lr = (downsampler(out) if kernel is None
              else downsampler.conv2d_with(out, kernel))
    err = (out_lr - lr_image).square()
    if lr_mask is None:
        return err.mean()
    count = torch.clamp(lr_mask.sum(), min=1.0) * err.shape[1]
    return (err * lr_mask).sum() / count


def dip_forward_backward(net, downsampler, z, noise, lr_image,
                         reg_noise_std: float, kernel=None,
                         lr_mask=None) -> torch.Tensor:
    """The loss at z + noise * reg_noise_std (z when noise is None) and its
    backward into the leaves' ``.grad``; returns the detached loss."""
    z_iter = z if noise is None else z + noise * reg_noise_std
    loss = dip_loss(net, downsampler, z_iter, lr_image, kernel, lr_mask)
    loss.backward()
    return loss.detach()


def _eager_step(optimizer, fwd_bwd: Callable[[], torch.Tensor]):
    """One eager optimizer step: the gradients set to None, ``fwd_bwd()``
    (which leaves them in ``.grad`` and returns the loss), the step."""
    optimizer.zero_grad(set_to_none=True)
    loss = fwd_bwd()
    optimizer.step()
    return loss


def dip_iteration(net, downsampler, optimizer, z, noise, lr_image,
                  reg_noise_std: float, kernel=None,
                  lr_mask=None) -> torch.Tensor:
    """One DIP step with the reg-noise draw given explicitly: the step a
    single-image call makes at every eager iteration.

    z, noise: (1, C, H, W); lr_image: (1, 3, h, w). ``noise=None`` skips
    the perturbation. The optimizer holds every trained leaf (the net's
    parameters, and z and the kernel when they are trained). Returns the
    (detached) loss; no host sync.
    """
    return _eager_step(optimizer, functools.partial(
        dip_forward_backward, net, downsampler, z, noise, lr_image,
        reg_noise_std, kernel, lr_mask))


class _GraphHome:
    """What every DIP graph on one card shares: the stream of the eager
    iterations and the captures, so that the per-stream state they warm
    (the workspace of each thread's cuBLAS handle, the allocator's cached
    blocks) serves every call; and the last graph captured, kept for its
    memory pool alone, which the next capture shares, so that it reuses
    the blocks the last stage freed and the card's reserved memory does not
    grow by a graph a call. Graphs in one pool must replay in the order
    they were captured; a stage's graph never replays once it is closed."""

    def __init__(self, dev: torch.device):
        self.stream = torch.cuda.Stream(dev)
        self.last = None

    def capture(self, fn):
        """A new graph of ``fn()`` on the stream, in the last graph's pool,
        after the caller's stream's work; returns (graph, fn's result)."""
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            graph.capture_begin(
                pool=None if self.last is None else self.last.pool())
            try:
                out = fn()
            finally:
                graph.capture_end()
        self.last = graph
        return graph, out


_graph_home = functools.cache(_GraphHome)  # one per card
# the launch counters of the kernels a DIP iteration runs
_COUNTERS = (fused_conv.LAUNCHES, bn_act.LAUNCHES)


class _AdamStage:
    """The Adam iterations of one stage of a single-image call (the run,
    or the L-BFGS path's warm-up). ``step()`` makes one iteration on the
    noise already drawn and returns its loss; no host sync.

    On a card, the forward and backward (``fwd_bwd``) of every iteration
    after the first EAGER_ITERS run as one CUDA graph. The eager iterations
    run them on the stream the capture uses, so that cuDNN's and cuBLAS's
    handles and workspaces, AccumulateGrad and Adam's state exist before
    it. The next iteration sets the gradients to None, so that the
    backward allocates them in the graph's pool, captures the graph without
    a host sync and replays it; every later iteration replays it, and
    every replay rewrites the same gradients. The graph reads only tensors
    that stay put for the stage: the net's leaves and buffers, z, the noise
    buffer, the LR image, its mask and the trained kernel. Adam stays an
    eager call on the caller's stream after each iteration, so PyTorch's
    optimizer-step hooks fire as in an eager loop, and the kernels'
    ``LAUNCHES`` (``_COUNTERS``) gain the launches the capture counted at
    every later replay. Elsewhere every iteration is eager. ``close()``
    drops the graph and frees the gradients in its pool, for the next
    capture (``_GraphHome``).
    """

    def __init__(self, optimizer, fwd_bwd: Callable[[], torch.Tensor],
                 dev: torch.device):
        self.optimizer, self.fwd_bwd = optimizer, fwd_bwd
        self.home = None
        if dev.type == "cuda":  # one home per card, however it is named
            self.home = _graph_home(torch.device(
                "cuda", torch.cuda.current_device() if dev.index is None
                else dev.index))
        self.eager_left = EAGER_ITERS
        self.graph = self.loss = None

    @property
    def mode(self) -> str:
        """How the next iteration runs: 'eager', 'capture' or 'replay'."""
        if self.home is None or self.eager_left > 0:
            return "eager"
        return "capture" if self.graph is None else "replay"

    def step(self) -> torch.Tensor:
        mode = self.mode
        if mode == "eager":
            if self.home is None:  # dip_iteration's step
                return _eager_step(self.optimizer, self.fwd_bwd)
            self.eager_left -= 1
            return _eager_step(self.optimizer, self._on_side_stream)
        if mode == "capture":
            self._capture()
        else:
            for counts, launched in zip(_COUNTERS, self.launches):
                for k, n in launched.items():
                    counts[k] += n
        self.graph.replay()
        self.optimizer.step()
        return self.loss

    def _on_side_stream(self):
        main, side = torch.cuda.current_stream(), self.home.stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fwd_bwd()
        main.wait_stream(side)
        return out

    def _capture(self) -> None:
        # not torch.cuda.graph, which synchronises and empties the cache
        self.optimizer.zero_grad(set_to_none=True)
        before = [dict(counts) for counts in _COUNTERS]
        self.graph, self.loss = self.home.capture(self.fwd_bwd)
        self.launches = [{k: n - b[k] for k, n in counts.items()}
                         for counts, b in zip(_COUNTERS, before)]

    def close(self) -> None:
        if self.graph is not None:
            self.optimizer.zero_grad(set_to_none=True)
        self.graph = self.loss = None


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
    """Write flat vectors into the leaves, in their order: x (n,) or
    (1, n) into one net's leaves, or the lanes' rows x (N, n) into stacked
    leaves (``stack_lanes``, the lane axis first)."""
    rows = x.numel() // x.shape[-1]
    offset = 0
    for p in leaves:
        size = p.numel() // rows
        p.copy_(x[..., offset:offset + size].reshape(p.shape))
        offset += size


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


def _lbfgs_stage(config: DIPConfig, x, value_and_grad, dev, leaves):
    """The L-BFGS stage after the warm-up, over N lanes' flat rows x (N, n)
    (one row for a single run): ``run(n_iter)`` makes n_iter iterations of
    ``config.lbfgs_line_search``, writes the rows back into ``leaves``
    (``_assign``) and returns (the N values at the last iteration's start,
    the gradient evaluations each lane made). ``value_and_grad(xs, lanes)``
    as ``lane_objective`` gives it."""
    n = x.shape[0]
    if config.lbfgs_line_search == "fixed":
        state = lbfgs_fixed_init_lanes(n, x.shape[1], config.lbfgs_memory,
                                       dev)

        def lbfgs_iter(p):
            nonlocal state
            values, g = value_and_grad(p, list(range(n)))
            upd, state = lbfgs_fixed_step_lanes(g, state,
                                                config.learning_rate)
            return p + upd.to(p.dtype), values, 1
    else:
        zoom = ZoomLBFGSLanes(n, x.shape[1], config.lbfgs_memory, dev,
                              x.dtype)

        def lbfgs_iter(p):
            before = np.asarray(zoom.evals)
            p, values = zoom.step(p, value_and_grad)
            return (p, torch.tensor(values, device=dev),
                    np.asarray(zoom.evals) - before)

    done = 0  # L-BFGS iterations so far

    def run(n_iter):
        nonlocal x, done
        values = torch.full((n,), float("nan"), device=dev)
        n_evals = np.zeros(n, np.int64)
        for _ in range(n_iter):
            with span("dip.lbfgs_iteration", index=done):
                x, values, k = lbfgs_iter(x)
                n_evals += k
            done += 1
        _assign(leaves, x)
        return values, n_evals

    return run


def stack_lanes(nets, device) -> dict[str, torch.Tensor]:
    """The lanes' parameters, each stacked along a new leading axis, as
    trainable leaves on ``device`` (one template net's names)."""
    named = [dict(net.named_parameters()) for net in nets]
    return {k: torch.stack([p[k].detach().to(device) for p in named])
            .requires_grad_() for k in named[0]}


def _lane_out(template, p, z_lane, update_stats: bool = False):
    # train-mode statistics; the running-statistics update is skipped
    # (vmap refuses its in-place write, and DIP never reads it)
    return torch.func.functional_call(template, p, (z_lane,),
                                      {"update_stats": update_stats})


def _lane_loss(template, downsampler, p, z_lane, lr_lane, k_lane, m_lane):
    """``dip_loss`` of one lane, for vmap."""
    return dip_loss(functools.partial(_lane_out, template, p), downsampler,
                    z_lane, lr_lane, k_lane, m_lane, update_stats=False)


def _lanes_loss(template, downsampler, kernel, lr_mask):
    """``_lane_loss`` vmapped over the lanes: (params, z, lr_images,
    kernel, lr_mask) -> (N,), the kernel and the mask per lane where
    given."""
    return torch.func.vmap(
        functools.partial(_lane_loss, template, downsampler),
        in_dims=(0, 0, 0, None if kernel is None else 0,
                 None if lr_mask is None else 0))


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
    loss_fn = _lanes_loss(template, downsampler, kernel, lr_mask)
    z_iter = z if noise is None else z + noise * reg_noise_std
    losses = loss_fn(params, z_iter, lr_images, kernel, lr_mask)
    optimizer.zero_grad(set_to_none=True)
    # lanes share no leaf, so the sum's gradient is each lane's own
    losses.sum().backward()
    optimizer.step()
    return losses.detach()


def lane_leaves(params, z, kernel=None) -> list[torch.Tensor]:
    """The lanes' trained leaves in ``flat_objective``'s order: the stacked
    parameters, then z and the kernel where they are trained (require
    grad)."""
    extra = [t for t in (z, kernel) if t is not None and t.requires_grad]
    return list(params.values()) + extra


def lane_objective(template, downsampler, params, z, lr_images, kernel=None,
                   lr_mask=None):
    """L-BFGS's view of the lanes' DIP losses, ``flat_objective`` per lane:
    (x, value_and_grad). x (N, n) holds each lane's ``lane_leaves`` as one
    flat row, in the order of its single run's flat vector.
    ``value_and_grad(xs, lanes)`` evaluates the lanes listed in ``lanes``
    at the rows of xs (len(lanes), n) and returns their losses (k,) and
    flat gradients (k, n): the deterministic objective (no reg noise,
    batch statistics, running statistics untouched), one vmapped forward
    and one backward of the losses' sum, whose gradient is each lane's own
    (lanes share no leaf). z, lr_images, kernel and lr_mask as
    ``lane_iteration`` takes them."""
    leaves = lane_leaves(params, z, kernel)
    names = list(params)
    shapes = [leaf.shape[1:] for leaf in leaves]
    sizes = [math.prod(sh) for sh in shapes]
    n = leaves[0].shape[0]
    train_z, train_k = z.requires_grad, (kernel is not None
                                         and kernel.requires_grad)
    loss_fn = _lanes_loss(template, downsampler, kernel, lr_mask)
    z, kernel = z.detach(), None if kernel is None else kernel.detach()

    def value_and_grad(xs, lanes):
        xs = xs.detach().requires_grad_()
        parts = [p.reshape(len(lanes), *sh)
                 for p, sh in zip(xs.split(sizes, 1), shapes)]
        rest = iter(parts[len(names):])
        sel = (None if len(lanes) == n
               else torch.tensor(lanes, device=xs.device))

        def pick(t):
            return t if sel is None or t is None else t.index_select(0, sel)

        losses = loss_fn(dict(zip(names, parts)),
                         next(rest) if train_z else pick(z), pick(lr_images),
                         next(rest) if train_k else pick(kernel),
                         pick(lr_mask))
        (grad,) = torch.autograd.grad(losses.sum(), xs)
        return losses.detach(), grad

    x = torch.cat([leaf.detach().reshape(n, -1) for leaf in leaves], 1)
    return x, value_and_grad


class _Seam:
    """What a call's single net and its lane set do differently;
    ``_dip_core`` does the rest. A seam lays out the call's nets (``named``:
    their trained parameters, stacked along a lane axis in a lane set) and
    gives ``stack`` (the lanes' tensors, each in the single net's layout,
    in the seam's), ``repeat`` (one tensor for every lane), ``bind``,
    ``mode`` (how the next Adam iteration runs), ``adam_iteration()`` (the
    next iteration's reg noise and step; the lanes' (N,) losses),
    ``forward_nhwc(z)`` ((N, 1, H, W, 3), running statistics untouched),
    ``objective()`` (L-BFGS's x (N, n) and value_and_grad(xs, lanes)) and
    ``close()``."""

    noise = None  # the last Adam iteration's reg noise, in the seam's layout

    def bind(self, z, lr, std, kernel, lr_mask, learning_rate):
        """The objective's tensors, in the seam's layout; its leaves, in
        ``flat_objective``'s order, and one Adam over them."""
        self.z, self.lr, self.std = z, lr, std
        self.kernel, self.lr_mask = kernel, lr_mask
        self.leaves = lane_leaves(self.named, z, kernel)
        self.optimizer = torch.optim.Adam(self.leaves, lr=learning_rate)

    def close(self):
        pass


class _SingleNet(_Seam):
    """One net (N = 1): a SkipNet in channels_last, with conv_fusion as
    configured. Its Adam iterations run through ``_AdamStage`` (replayed
    as a CUDA graph on a card), each drawing its reg noise into one buffer,
    which a graph can read (the same draws as torch.randn's); L-BFGS
    through ``flat_objective``."""

    mode = property(lambda self: self.stage.mode)

    def __init__(self, nets, downsampler, dev_gens, shape, dev):
        (self.net,), (self.gen,) = nets, dev_gens
        self.net.to(dev, memory_format=torch.channels_last)
        self.down = downsampler.to(dev)
        self.named = dict(self.net.named_parameters())
        self.shape, self.dev = shape, dev

    @staticmethod
    def stack(ts):
        return ts[0]

    @staticmethod
    def repeat(t):
        return t

    def bind(self, *args):
        super().bind(*args)
        self.noise_hwc = (torch.empty(self.shape, device=self.dev)
                          if self.std > 0 else None)
        # the graph reads the buffer through one view; the stage holds no
        # reference to the seam, so a call's tensors go when it returns
        self.stage = _AdamStage(self.optimizer, functools.partial(
            dip_forward_backward, self.net, self.down, self.z,
            None if self.noise_hwc is None else _nchw(self.noise_hwc),
            self.lr, self.std, self.kernel, self.lr_mask), self.dev)
        self.close = self.stage.close

    def adam_iteration(self):
        if self.noise_hwc is not None:
            self.noise = _nchw(self.noise_hwc.normal_(generator=self.gen))
        return self.stage.step().reshape(1)

    def forward_nhwc(self, z):
        return self.net(z, update_stats=False).permute(0, 2, 3, 1)[None]

    def objective(self):
        x, value_and_grad = flat_objective(self.net, self.down, self.leaves,
                                           self.z, self.lr, self.kernel,
                                           self.lr_mask)
        return x[None], one_lane(value_and_grad)


class _LaneSet(_Seam):
    """N lanes as one batched computation (tpusr's vmap): the lanes'
    parameters stacked along a leading axis (``stack_lanes``) and
    ``torch.func.vmap`` over ``functional_call`` of one template net,
    built with conv_fusion 'off'. Its Adam iterations are eager
    ``lane_iteration``s, each lane's reg noise drawn from its own device
    generator outside vmap and stacked (vmap's own randomness would not
    reproduce a lane's stream); L-BFGS through ``lane_objective``."""

    mode = "eager"
    stack = staticmethod(torch.stack)

    def __init__(self, nets, downsampler, dev_gens, shape, dev):
        self.template = nets[0].to(dev)
        self.down = downsampler.to(dev)
        self.named = stack_lanes(nets, dev)
        self.gens, self.shape, self.dev = dev_gens, shape, dev

    def repeat(self, t):
        return t[None].expand(len(self.gens), *t.shape).contiguous()

    def adam_iteration(self):
        self.noise = None if self.std == 0 else torch.stack([
            _nchw(torch.randn(self.shape, generator=g, device=self.dev))
            for g in self.gens])
        return lane_iteration(self.template, self.down, self.named,
                              self.optimizer, self.z, self.noise, self.lr,
                              self.std, self.kernel, self.lr_mask)

    def forward_nhwc(self, z):
        return torch.func.vmap(functools.partial(_lane_out, self.template))(
            self.named, z).permute(0, 1, 3, 4, 2)

    def objective(self):
        return lane_objective(self.template, self.down, self.named, self.z,
                              self.lr, self.kernel, self.lr_mask)


def _dip_core(lr_images, hr_images, config: DIPConfig, generators, device,
              lpips_fn: Callable | None, valid_hws, seam_type):
    """N images' DIP runs, one fresh net each, on a ``seam_type`` of N
    lanes (``_SingleNet`` for one image, ``_LaneSet``).

    Lane i is the single-image run with ``generators[i]``: its net is
    initialised from it, and the device generator it seeds draws the lane's
    z and reg noise. L-BFGS runs on the lanes' (N, n) stack of flat
    vectors: 'fixed' steps every lane with no host sync; 'zoom' runs one
    line search per lane on the host, each round one batched
    value-and-gradient call over the lanes still searching, so each lane
    takes its single run's trial points. Returns (N, 1, H, W, 3) and
    curves (N, chunks).
    """
    dev, generators = resolve_device(device), list(generators)
    with span("dip.call", lanes=len(generators)):
        if config.optimizer not in ("adam", "lbfgs"):
            raise ValueError(f"unknown optimizer {config.optimizer!r}")
        if (config.optimizer == "lbfgs"
                and config.lbfgs_line_search not in ("fixed", "zoom")):
            raise ValueError(
                f"unknown lbfgs_line_search {config.lbfgs_line_search!r}")
        parts = {p.strip() for p in config.opt_over.split(",")}
        unknown = parts - {"net", "input", "down"}
        if unknown:
            raise ValueError(f"unknown opt_over parts {sorted(unknown)}")
        if config.input_method not in ("noise", "meshgrid"):
            raise ValueError(f"unknown input method {config.input_method!r}")
        if config.input_method == "meshgrid" and config.input_depth != 2:
            raise ValueError("meshgrid input requires input_depth=2")
        if seam_type is _LaneSet:  # as in tpusr, no kernel runs under vmap
            config = dataclasses.replace(config, conv_fusion="off")
        n = len(generators)
        if not (len(lr_images) == len(hr_images) == n):
            raise ValueError("lr_images, hr_images and generators differ in "
                             "length")
        hr = [_image(a, dev) for a in hr_images]  # N of (1, H, W, 3)
        _, h, w, _ = hr[0].shape
        shape = (1, h, w, config.input_depth)

        with span("dip.build"):
            nets, dev_gens = [], []
            for gen in generators:
                net, downsampler = build(config, gen)
                nets.append(net)
                dev_gens.append(torch.Generator(device=dev).manual_seed(
                    int(torch.randint(0, 2 ** 62, (1,), generator=gen))))
            seam = seam_type(nets, downsampler, dev_gens, shape, dev)

        if config.input_method == "noise":
            z = seam.stack([_nchw(torch.rand(shape, generator=g, device=dev))
                            for g in dev_gens]) * config.input_noise_scale
        else:
            z = seam.repeat(_nchw(meshgrid_input(h, w).to(dev)))
        if "input" in parts:
            z = z.detach().clone().requires_grad_()
        kernel = None
        if "down" in parts:
            kernel = (seam.repeat(downsampler.kernel.detach()).clone()
                      .requires_grad_())
        lr = seam.stack([_nchw(_image(a, dev)) for a in lr_images])
        lr_mask = None
        if valid_hws is not None:
            valid_hws = [(int(v[0]), int(v[1])) for v in valid_hws]
            lr_mask = seam.stack([
                _valid_mask(lr.shape[-2:], (v[0] // config.factor,
                                            v[1] // config.factor),
                            dev)[..., 0][None, None] for v in valid_hws])
        # one metrics head per log_freq iterations (one when fewer)
        chunk_len = min(config.num_iter, config.log_freq)
        n_chunks = config.num_iter // config.log_freq or 1
        seam.bind(z, lr, config.reg_noise_std, kernel, lr_mask,
                  config.learning_rate if config.optimizer == "adam"
                  else WARMUP_LR)
        done = 0  # Adam iterations so far, the warm-up's included

        def adam_run(n_iter):
            """(the N losses of the last of n_iter iterations, each lane's
            gradient evaluations), as an L-BFGS stage's ``run`` gives."""
            nonlocal done
            losses = torch.full((n,), float("nan"), device=dev)
            for _ in range(n_iter):
                with span("dip.iteration", index=done,
                          optimizer=seam.optimizer, graph=seam.mode):
                    losses = seam.adam_iteration()
                done += 1
            # a replay's loss is the graph's own tensor
            return losses.clone(), np.full(n, n_iter, np.int64)

        heads, losses, evals = [], [], []
        try:
            run = adam_run
            if config.optimizer == "lbfgs":
                adam_run(WARMUP_ITERS)
                seam.close()
                seam.noise = None  # the L-BFGS stage and its resolve are noise-free
                run = _lbfgs_stage(config, *seam.objective(), dev,
                                   seam.leaves)
            for _ in range(n_chunks):
                # chunk head: iteration % log_freq == 0, (N, 3)
                with span("dip.head"), torch.no_grad():
                    heads.append(torch.stack([torch.stack(_head(
                        out, hr_i, valid, lpips_fn)) for out, hr_i, valid
                        in zip(seam.forward_nhwc(z), hr,
                               valid_hws or [None] * n)]))
                values, n_evals = run(chunk_len)
                losses.append(values)
                evals.append(n_evals)
            # the remainder counts in the last chunk
            evals[-1] = evals[-1] + run(config.num_iter
                                        - n_chunks * chunk_len)[1]
        finally:
            seam.close()

        with span("dip.resolve"), torch.no_grad():
            z_final = z
            if not config.resolve_clean and seam.noise is not None:
                z_final = z + seam.noise * seam.std
            resolved = seam.forward_nhwc(z_final).contiguous()
            m = torch.stack(heads, 1).float().cpu().numpy()  # (N, chunks, 3)
            curves = {"psnr": m[..., 0], "ssim": m[..., 1],
                      "lpips": m[..., 2],
                      "loss": torch.stack(losses, 1).float().cpu().numpy(),
                      "evals": np.stack(evals, 1)}
        return resolved, curves


def _single(lr_image, hr_image, config, generator, device, lpips_fn,
            valid_hw=None):
    """One image's call: one lane on a ``_SingleNet``, the lane axis taken
    off the image and the curves."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    resolved, curves = _dip_core(
        [lr_image], [hr_image], config, [generator], device, lpips_fn,
        None if valid_hw is None else [valid_hw], _SingleNet)
    return resolved[0], {k: v[0] for k, v in curves.items()}


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
    return _single(lr_image, hr_image, config, generator, device, lpips_fn)


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
    return _single(lr_image, hr_image, config, generator, device, lpips_fn,
                   valid_hw)


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


def dip_superresolve_batch(lr_images, hr_images,
                           generators: Sequence[torch.Generator],
                           config: DIPConfig,
                           device: str | torch.device = "cuda",
                           lpips_fn: Callable | None = None):
    """Multi-image DIP as one batched computation (tpusr's vmap).

    lr_images (N, 1, h, w, 3), hr_images (N, 1, H, W, 3), N generators:
    each lane optimises a fresh net of its own, as ``dip_superresolve``
    with that generator and conv_fusion 'off' would, with Adam or L-BFGS
    ('fixed' or 'zoom', the lanes batched through ``lane_objective``).
    Returns (N, 1, H, W, 3) and curves with a leading N axis ('evals' per
    lane: each lane's own gradient evaluations, as its single run counts
    them).
    """
    return _dip_core(lr_images, hr_images, config, generators, device,
                     lpips_fn, None, _LaneSet)


def dip_superresolve_batch_bucketed(lr_images, hr_images, valid_hws,
                                    generators: Sequence[torch.Generator],
                                    config: DIPConfig,
                                    device: str | torch.device = "cuda",
                                    lpips_fn: Callable | None = None):
    """The lane batch over images zero-padded to one bucket; valid_hws
    (N, 2) the true HR sizes: each lane's loss and curves are masked to
    its own valid region (``dip_superresolve_bucketed`` per lane)."""
    return _dip_core(lr_images, hr_images, config, generators, device,
                     lpips_fn, valid_hws, _LaneSet)


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
