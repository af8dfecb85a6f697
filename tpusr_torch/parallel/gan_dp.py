"""Data-parallel SRGAN training over a device mesh.

Counterpart of ``tpusr/parallel/gan_dp.py``. tpusr replicates the state,
shards the patch batch on the 'data' axis and lets GSPMD insert the
all-reduces; its BatchNorm moments come out over the *global* batch. Here
each rank is a process that holds a full copy of the state and its slice
of the batch, and the step calls its collectives itself:

  * BatchNorm statistics over the global batch (``stats_over``, which
    hands ``models.layers.global_batch_stats`` one differentiable
    all-reduce of 2C floats per layer), so the running statistics stay
    equal on every rank;
  * after D's backward and after G's ``autograd.grad``, each net's
    gradients are summed over the ranks in one flat f32 buffer and divided
    by W, before its Adam step. Every loss term is a mean over the local
    batch, so that is the gradient of the global batch's loss;
  * the logged losses are their mean over the ranks.

``make_dp_forward`` gives the trainers (``engine/gan_epochs.py``, the CLI's
host loop) the matching metrics forward.

Explicit all-reduces, not DDP: G's gradient comes from ``autograd.grad``
and D may step a hand-written bf16 Adam, which DDP's hooks do not see.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpusr_torch.engine import losses as L
from tpusr_torch.engine.gan import (Bf16Adam, GANTrainConfig, GANTrainState,
                                    _check_fusion, _d_update, _g_forward,
                                    _g_update, adam_moments,
                                    generator_forward, set_adam_moments)
from tpusr_torch.models.layers import global_batch_stats
from tpusr_torch.parallel.mesh import (all_gather, all_reduce,
                                       all_reduce_grad, axis_of,
                                       batch_sharded, broadcast_, replicated)


def mean_grads(params, group, world: int) -> None:
    """Replace each parameter's gradient by its mean over the group's
    ranks: one all-reduce of one flat f32 buffer."""
    grads = [p.grad for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1).float() for g in grads]),
                      group) / world
    offset = 0
    with torch.no_grad():
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def stats_over(group, world: int):
    """``global_batch_stats`` over the ranks of ``group``: BatchNorm sums
    its moments with the differentiable all-reduce."""
    return global_batch_stats(lambda t: all_reduce_grad(t, group), world)


def make_dp_train_step(mesh, config: GANTrainConfig, learning_rate: float,
                       content_loss: Callable = L.mse, axis: str = "data"):
    """Return (place_state, step_fn) for data-parallel training.

    ``place_state(state)`` makes every rank hold rank 0's state (both
    nets' parameters and running statistics, both Adam states, the step
    count) and sets both optimizers' learning rate to ``learning_rate``;
    ``step_fn(state, lr_batch, hr_batch)`` takes the global batch (NHWC,
    as ``gan_train_step`` takes it), keeps this rank's slice and runs
    ``gan_train_step``'s three parts with the global statistics and mean
    gradients. It returns (state, the losses' mean over the ranks). The
    batch must divide by the axis size and the state must be equal on
    every rank, as ``place_state`` leaves it.
    """
    group, _, world = axis_of(mesh, axis)

    def place_state(state: GANTrainState) -> GANTrainState:
        for net in (state.G, state.D):
            replicated(mesh, list(net.parameters()) + list(net.buffers()),
                       axis)
        dev = next(state.G.parameters()).device
        for opt in (state.opt_G, state.opt_D):
            count, ms, vs = adam_moments(opt)
            head = torch.tensor([count, state.step], dtype=torch.float64,
                                device=dev)
            broadcast_(head, group)
            for t in list(ms) + list(vs):
                broadcast_(t, group)
            if int(head[0]) > 0 or count > 0:
                set_adam_moments(opt, int(head[0]), ms, vs)
            step = int(head[1])
            if isinstance(opt, Bf16Adam):
                opt.lr = learning_rate
            else:
                for g in opt.param_groups:
                    g["lr"] = learning_rate
        state.step = step
        return state

    def reduce(params):
        mean_grads(params, group, world)

    def step_fn(state: GANTrainState, lr_batch: torch.Tensor,
                hr_batch: torch.Tensor):
        _check_fusion(config)
        lr_local = batch_sharded(mesh, lr_batch, axis)
        hr_local = batch_sharded(mesh, hr_batch, axis)
        with stats_over(group, world):
            fake = _g_forward(state, lr_local, config)
            loss_D = _d_update(state, fake, hr_local, config, reduce)
            loss_G = _g_update(state, fake, hr_local, config, content_loss,
                               reduce)
        state.step += 1
        losses = all_reduce(torch.stack([loss_D, loss_G]).float(),
                            group) / world
        return state, {"loss_D": losses[0], "loss_G": losses[1]}

    return place_state, step_fn


def make_dp_forward(mesh, config: GANTrainConfig, axis: str = "data"):
    """Return ``forward_fn(state, lr_batch)``: the train-mode generator
    forward that the trainers' metrics score, of the global batch. Each
    rank runs its slice under the global statistics; the outputs are
    gathered, so every rank scores the whole batch."""
    group, _, world = axis_of(mesh, axis)

    def forward_fn(state: GANTrainState, lr_batch: torch.Tensor):
        with stats_over(group, world):
            out = generator_forward(state.G, batch_sharded(mesh, lr_batch,
                                                           axis),
                                    config, train=True)
        return all_gather(out, group)

    return forward_fn
