"""Multi-chip / multi-host parallelism (SURVEY.md sections 2.4 and 5).

The reference is single-GPU (one CUDA/OpenCL device; SIMT pixel grid is
its only parallel axis — CudaKernel::render_begin launch).  Here
parallelism over several cards is first-class:

  * tile data-parallel rendering: pixel rows sharded over a
    `jax.sharding.Mesh`, scene/BVH replicated (broadcast once) —
    `parallel.render.shard_render`;
  * distributed inverse rendering: per-device tile losses, scene-param
    gradients `psum`/reduce-scattered over the mesh —
    `parallel.grads.make_sharded_train_step`;
  * the collectives are XLA's: `psum`, `all_gather`, `ppermute`
    inside `shard_map`, which XLA hands to NCCL on GPUs.
"""

from solstice.parallel.mesh import (
    device_count,
    make_host_chip_mesh,
    make_mesh,
)
from solstice.parallel.render import shard_render
from solstice.parallel.ring import ring_closest_hit, shard_triangles
from solstice.parallel.grads import (
    init_zero_opt_state,
    make_sharded_train_step,
    sharded_loss_grad,
)
from solstice.parallel.distributed import (
    initialize_distributed,
    is_distributed,
    process_info,
)

__all__ = [
    "make_mesh",
    "make_host_chip_mesh",
    "device_count",
    "shard_render",
    "make_sharded_train_step",
    "init_zero_opt_state",
    "sharded_loss_grad",
    "initialize_distributed",
    "is_distributed",
    "process_info",
]
