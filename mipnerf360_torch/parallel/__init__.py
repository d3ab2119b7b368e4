"""Data, tensor and sample-axis parallelism over ``torch.distributed``
(counterpart of ``mipnerf360_tpu/parallel/``)."""
from .mesh import (Mesh, default_render_mesh, init_distributed, is_primary,
                   make_mesh, shutdown)
from .sample_axis import make_sample_sharded_composite

__all__ = ["Mesh", "default_render_mesh", "init_distributed", "is_primary",
           "make_mesh", "make_sample_sharded_composite", "shutdown"]
