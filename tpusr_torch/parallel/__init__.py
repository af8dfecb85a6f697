"""tpusr_torch.parallel."""

from tpusr_torch.parallel.dip_batch import dip_superresolve_sharded
from tpusr_torch.parallel.gan_dp import make_dp_train_step
from tpusr_torch.parallel.mesh import make_mesh
from tpusr_torch.parallel.spatial import (sharded_generator_forward,
                                          tiled_generator_forward)

__all__ = [
    "make_mesh",
    "dip_superresolve_sharded",
    "make_dp_train_step",
    "sharded_generator_forward",
    "tiled_generator_forward",
]
