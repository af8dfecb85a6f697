"""Spatial parallelism for full-image SR inference.

Port of ``tpusr/parallel/spatial.py``:

  * ``tiled_generator_forward`` (one card): the LR image is split along H
    into ``n_tiles`` cores; each core is read with ``halo`` rows of context
    as a window of one uniform size clamped inside the image (an edge
    window shifts inward, so the true image edges keep the per-layer zero
    padding of a whole-image forward). The windows run as one batch
    through ``generator_forward`` and the upscaled cores are cut out and
    concatenated. Exact when the halo covers the generator's LR receptive
    field.

  * ``sharded_generator_forward`` (a 'spatial' mesh axis of W ranks): each
    rank holds an H-slab, swaps ``halo`` rows with its neighbours (one
    ``batch_isend_irecv`` each way, tpusr's ``lax.ppermute``), runs
    ``generator_forward`` on its window (kernel A on the card) and the
    upscaled cores are all-gathered along H, so every rank returns the
    whole image. EXACT, the true image edges included, when slab >=
    2*halo: edge ranks shift their window inward with one more
    single-pair exchange, the tiled path's geometry. When halo <= slab <
    2*halo it falls back to zero-filled edge halos (interior-exact only,
    warned); a halo above the slab is clamped to it (warned).

Both take SRGAN's generator alone: ``generator_receptive_halo`` is SRGAN's,
and a config of a generator class without ``tiles`` (RRDBNet; SwinIR, whose
tiles would also have to be window-aligned) raises ValueError.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from tpusr_torch.engine.gan import (GANTrainConfig, generator_class,
                                    generator_forward)
from tpusr_torch.parallel.mesh import all_gather, axis_of, exchange, make_mesh


def generator_receptive_halo(config: GANTrainConfig) -> int:
    """LR-domain halo covering the SRGAN generator's pre-upsample receptive
    field, padded; ValueError for any other generator."""
    if not generator_class(config).tiles:
        raise ValueError(f"spatial tiling and sharding take the SRGAN "
                         f"generator only (its halo is SRGAN's), not "
                         f"{config.generator!r}")
    return 2 * config.residual_blocks_count + 16


def tiled_generator_forward(generator, lr_image: torch.Tensor,
                            config: GANTrainConfig, n_tiles: int = 4,
                            halo: int | None = None) -> torch.Tensor:
    """lr_image (1, H, W, 3) NHWC -> (1, H*f, W*f, 3), as the whole-image
    ``generator_forward(generator, lr_image, config)``."""
    receptive = generator_receptive_halo(config)  # raises unless SRGAN
    if halo is None:
        halo = receptive
    _, h, w, _ = lr_image.shape
    f = config.factor
    core = -(-h // n_tiles)
    window = min(h, core + 2 * halo)

    windows, cores = [], []
    for i in range(n_tiles):
        c0 = i * core
        if c0 >= h:
            break  # h < n_tiles * core: the image is covered already
        c1 = min(c0 + core, h)
        w0 = min(max(c0 - halo, 0), h - window)
        windows.append(lr_image[0, w0:w0 + window])
        cores.append((c0 - w0, c1 - c0))

    out = generator_forward(generator, torch.stack(windows), config,
                            train=False)
    return torch.cat([out[i, off * f:(off + n) * f]
                      for i, (off, n) in enumerate(cores)])[None]


def sharded_generator_forward(generator, lr_image: torch.Tensor,
                              config: GANTrainConfig,
                              n_shards: int | None = None,
                              halo: int | None = None, mesh=None,
                              axis: str = "spatial") -> torch.Tensor:
    """Distributed full-image inference: an H-slab per rank + halo swaps.

    lr_image: (1, H, W, 3) NHWC, the whole image on every rank, H
    divisible by the shard count (the ``axis`` size of ``mesh``, else
    ``n_shards``, else the group's world size). Returns (1, H*f, W*f, 3)
    on every rank. One shard is the whole-image forward; without a mesh,
    one is made over the group (``make_mesh({axis: n})``).
    """
    receptive = generator_receptive_halo(config)  # raises unless SRGAN
    if halo is None:
        halo = receptive
    if mesh is not None:
        n = axis_of(mesh, axis)[2]
    else:
        n = n_shards or (dist.get_world_size() if dist.is_initialized()
                         else 1)
    _, h, w, _ = lr_image.shape
    if h % n != 0:
        raise ValueError(f"image height {h} not divisible by {n} shards")
    if n == 1:
        return generator_forward(generator, lr_image, config, train=False)
    if mesh is None:
        mesh = make_mesh({axis: n}, lr_image.device.type)
    slab = h // n
    if halo > slab:
        # one exchange moves at most a neighbour's whole slab; below the
        # receptive field the interior is no longer exact
        warnings.warn(
            f"spatial halo clamped from {halo} to slab height {slab} "
            f"(< receptive halo {receptive}): "
            f"interior shard boundaries are now approximate. Use fewer "
            f"shards or tiled_generator_forward for exact output.",
            stacklevel=2)
        halo = slab
    edge_exact = 2 * halo <= slab
    if not edge_exact:
        warnings.warn(
            f"slab height {slab} < 2*halo ({2 * halo}): edge shards cannot "
            f"shift their window inward, falling back to zero-filled edge "
            f"halos — output is interior-exact only. Use fewer shards (or "
            f"tiled_generator_forward) for full exactness.",
            stacklevel=2)
    group, rank, _ = axis_of(mesh, axis)
    core = _slab_forward(generator, lr_image[:, rank * slab:(rank + 1) * slab],
                         config, halo, group, rank, n, edge_exact)
    return all_gather(core, group, dim=1)


def _slab_forward(generator, slab, config, halo, group, rank, n,
                  edge_exact):
    """This rank's upscaled core: exchange halos, run the generator, crop.

    edge_exact (slab >= 2*halo): edge ranks build an inward-shifted window
    of real image rows, so the generator's per-layer zero padding falls on
    the true image boundary (a zero-filled halo is not equivalent: after
    the first conv, bias and activation, zero rows become nonzero
    features). The 2*halo rows an edge rank needs from its one neighbour
    ride a second, single-pair exchange.
    """
    f = config.factor
    dev = slab.device
    rows = (1, halo) + tuple(slab.shape[2:])
    top, bottom = rank == 0, rank == n - 1
    zeros = slab.new_zeros(rows)

    # my bottom rows -> the rank below (its top halo); my top rows -> the
    # rank above (its bottom halo)
    sends = ([(slab[:, -halo:], rank + 1)] if not bottom else []) + \
        ([(slab[:, :halo], rank - 1)] if not top else [])
    recvs = ([(rows, slab.dtype, rank - 1)] if not top else []) + \
        ([(rows, slab.dtype, rank + 1)] if not bottom else [])
    got = exchange(sends, recvs, group, dev)
    from_above = zeros if top else got.pop(0)
    from_below = zeros if bottom else got.pop(0)

    if not edge_exact:
        padded = torch.cat([from_above, slab, from_below], dim=1)
        out = generator_forward(generator, padded, config, train=False)
        return out[:, halo * f:out.shape[1] - halo * f]

    # the second exchange: rank 0 also needs rank 1's rows [halo, 2 halo),
    # rank n-1 also needs rank n-2's rows [-2 halo, -halo)
    sends, recvs = [], []
    if rank == 1:
        sends.append((slab[:, halo:2 * halo], 0))
    if rank == n - 2:
        sends.append((slab[:, -2 * halo:-halo], n - 1))
    if top:
        recvs.append((rows, slab.dtype, 1))
    if bottom:
        recvs.append((rows, slab.dtype, n - 2))
    got = exchange(sends, recvs, group, dev)
    from_below2 = got.pop(0) if top else zeros
    from_above2 = got.pop(0) if bottom else zeros

    # a (slab + 4 halo)-row strip; each rank's window is (slab + 2 halo)
    # rows of it: interior from halo, the top rank from 2 halo (rows [0,
    # slab + 2 halo) of the image), the bottom rank from 0
    strip = torch.cat([from_above2, from_above, slab, from_below,
                       from_below2], dim=1)
    start = 2 * halo if top else 0 if bottom else halo
    window = strip[:, start:start + slab.shape[1] + 2 * halo]
    out = generator_forward(generator, window, config, train=False)
    # the core's offset in the upscaled window mirrors the window's shift
    off = (0 if top else 2 * halo if bottom else halo) * f
    return out[:, off:off + slab.shape[1] * f]
