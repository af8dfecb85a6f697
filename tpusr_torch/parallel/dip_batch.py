"""Batched DIP across a device mesh.

Counterpart of ``tpusr/parallel/dip_batch.py``. DIP fits an independent
fresh net per image, so multi-image DIP needs no collective while it
optimises: each rank of the 'data' axis runs its N/W lanes through the
lane batch (``engine/dip.py::dip_superresolve_batch``, Adam or L-BFGS
'fixed' / 'zoom': a rank's line searches wait on its own lanes only) and
the results are all-gathered at the end, so every rank returns all N
images and curves, as tpusr's global array does.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from tpusr_torch.engine.dip import DIPConfig, dip_superresolve_batch
from tpusr_torch.parallel.mesh import all_gather, axis_of, make_mesh


def dip_superresolve_sharded(lr_images, hr_images,
                             generators: Sequence[torch.Generator],
                             config: DIPConfig, mesh=None,
                             lpips_fn: Callable | None = None,
                             axis: str = "data",
                             device: str | torch.device = "cuda"):
    """Run the lane batch with the image axis split over ``mesh``'s
    ``axis`` (a mesh over the group when None).

    lr (N, 1, h, w, 3), hr (N, 1, H, W, 3) and N generators, the same on
    every rank; N must divide by the axis size. Rank r runs lanes
    [r N/W, (r + 1) N/W). Returns ((N, 1, H, W, 3) on ``device``, curves
    with a leading N axis), equal on every rank.
    """
    if mesh is None:
        mesh = make_mesh({axis: torch.distributed.get_world_size()
                          if torch.distributed.is_initialized() else 1},
                         torch.device(device).type)
    group, rank, world = axis_of(mesh, axis)
    n = len(generators)
    if n % world:
        raise ValueError(f"{n} images do not divide over {world} ranks")
    per = n // world
    mine = slice(rank * per, (rank + 1) * per)
    resolved, curves = dip_superresolve_batch(
        lr_images[mine], hr_images[mine], list(generators)[mine], config,
        device, lpips_fn)
    resolved = all_gather(resolved, group)
    curves = {k: all_gather(torch.from_numpy(np.ascontiguousarray(v))
                            .to(resolved.device), group).cpu().numpy()
              for k, v in curves.items()}
    return resolved, curves
