"""Data parallelism of the train step over ``torch.distributed`` (the port of
``mocopci_tpu/parallel/mesh.py``; the step is ``training.loop.dp_train_step``)."""
from mocopci_torch.parallel.mesh import (
    barrier,
    host_batch_slice,
    init_distributed,
    make_mesh_for_batch,
    rank_generator,
    scale_batch_to_mesh,
    shutdown_distributed,
    world,
)

__all__ = ["barrier", "host_batch_slice", "init_distributed", "make_mesh_for_batch",
           "rank_generator", "scale_batch_to_mesh", "shutdown_distributed", "world"]
