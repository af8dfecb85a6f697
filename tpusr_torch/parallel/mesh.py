"""Process groups, device meshes and the collectives of the multi-device
paths.

Counterpart of ``tpusr/parallel/mesh.py``. tpusr lays a
``jax.sharding.Mesh`` over its devices and XLA inserts the collectives;
here every device is one process of a ``torch.distributed`` group, a
``DeviceMesh`` names its axes, and the paths call their collectives
themselves (``all_reduce``, ``all_gather``, ``broadcast``, ``exchange``).

Transport: NCCL for CUDA tensors, gloo for CPU tensors. A gloo group
that carries CUDA tensors (several processes sharing one card, which NCCL
refuses) is taken only when asked for (``make_mesh(backend='gloo')``);
its mesh is a 'cpu' mesh and every collective stages its tensor through
host memory. Every path also runs at world size 1: ``make_mesh`` with no
group initialised sets up a one-rank group (a FileStore in a temp dir).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None, device: str = "cuda") -> None:
    """Join the process group this process was launched into.

    With no arguments the group comes from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); a CUDA rank takes the
    card LOCAL_RANK. NCCL for ``device='cuda'``, gloo for 'cpu', unless
    ``backend`` says otherwise.
    """
    if dist.is_initialized():
        return
    backend = backend or _BACKEND[torch.device(device).type]
    if torch.device(device).type == "cuda" and backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)


def make_mesh(axis_sizes: dict[str, int] | None = None, devices: str = "cuda",
              backend: str | None = None):
    """A ``DeviceMesh`` over every rank of the process group.

    Default: all ranks on one 'data' axis; ``make_mesh({'data': 4,
    'spatial': 2})`` lays out 8 ranks on two axes. ``devices`` is the
    device type the ranks compute on. A CUDA mesh needs NCCL and raises
    without it; ``backend='gloo'`` is the explicit exception (ranks that
    share a card), whose collectives go through host memory. With no group
    initialised, a one-rank group is set up.
    """
    dev = torch.device(devices).type
    if backend is None:
        backend = _BACKEND[dev]
    if dev == "cuda" and backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch "
                           "lacks; pass backend='gloo' to stage the "
                           "collectives through host memory")
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="tpusr_pg_"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=1, rank=0)
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have}, the mesh asks "
                           f"for {backend} on {dev}")
    world = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {"data": world}
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {int(np.prod(sizes))} "
                         f"ranks; the group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    mesh_type = "cuda" if backend == "nccl" else "cpu"
    return init_device_mesh(mesh_type, sizes,
                            mesh_dim_names=tuple(axis_sizes.keys()))


def axis_of(mesh, axis: str):
    """(group, this rank's index on ``axis``, the axis size)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def _host(group, t: torch.Tensor) -> bool:
    """Whether a collective over ``group`` stages ``t`` through the host
    (gloo carrying a CUDA tensor)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor, no
    gradient)."""
    if _host(group, t):
        buf = t.detach().cpu()
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)
    buf = t.detach().clone()
    dist.all_reduce(buf, group=group)
    return buf


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def all_reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, differentiable: its
    backward sums the cotangents over the ranks (each rank's loss depends
    on every rank's input through the sum)."""
    return _SumOverRanks.apply(t, group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each), concatenated along ``dim``
    in rank order."""
    src = t.detach().contiguous()
    if _host(group, t):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> None:
    """Overwrite ``t`` in place with the group's rank ``src``'s copy."""
    peer = dist.get_global_rank(group, src)
    if _host(group, t):
        buf = t.detach().cpu()
        dist.broadcast(buf, peer, group=group)
        with torch.no_grad():
            t.copy_(buf)
        return
    with torch.no_grad():
        if t.is_contiguous():
            dist.broadcast(t, peer, group=group)
        else:
            buf = t.contiguous()
            dist.broadcast(buf, peer, group=group)
            t.copy_(buf)


def exchange(sends, recvs, group, device) -> list[torch.Tensor]:
    """Point-to-point: ``sends`` is [(tensor, group rank)], ``recvs`` is
    [(shape, dtype, group rank)]; all are posted at once
    (``batch_isend_irecv``). Returns the received tensors in order, on
    ``device``."""
    device = torch.device(device)
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    wire = torch.device("cpu") if host else device
    ops, out = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, t.detach().contiguous().to(wire),
                              dist.get_global_rank(group, peer), group))
    for shape, dtype, peer in recvs:
        buf = torch.empty(shape, dtype=dtype, device=wire)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group))
        out.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(device) for b in out]


def replicated(mesh, module_tensors, axis: str = "data") -> None:
    """Make every rank hold rank 0's copy of the given tensors (the port's
    form of tpusr's ``replicated`` sharding): broadcast in place."""
    group, _, _ = axis_of(mesh, axis)
    for t in module_tensors:
        broadcast_(t, group)


def batch_sharded(mesh, batch: torch.Tensor, axis: str = "data"
                  ) -> torch.Tensor:
    """This rank's contiguous slice of a global batch (tpusr's
    ``batch_sharded``): rows [r B/W, (r + 1) B/W). B must divide by W."""
    _, rank, world = axis_of(mesh, axis)
    b = batch.shape[0]
    if b % world:
        raise ValueError(f"batch {b} does not divide over {world} ranks")
    per = b // world
    return batch[rank * per:(rank + 1) * per]


def spawn(fn, nprocs: int, args=(), backend: str | None = None,
          device: str = "cuda", store_dir: str | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes joined in one
    group (a FileStore, no TCP port). A CUDA rank with NCCL takes card
    rank % cards; with gloo every rank computes on the current card. Raises
    when any rank fails."""
    import torch.multiprocessing as mp

    backend = backend or _BACKEND[torch.device(device).type]
    store_dir = store_dir or tempfile.mkdtemp(prefix="tpusr_pg_")
    store = os.path.join(store_dir, "store")
    mp.spawn(_spawned, args=(fn, nprocs, store, backend, device, tuple(args)),
             nprocs=nprocs, join=True)


def _spawned(rank, fn, nprocs, store, backend, device, args):
    if torch.device(device).type == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=nprocs, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()
