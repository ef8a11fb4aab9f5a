"""Parallelism: process meshes, data parallelism, ZeRO-1, case sharding,
ring attention and tensor parallelism (port of the JAX package's
``parallel/``). A mesh is a
``torch.distributed`` process group with one rank per device."""

from multimodal_organ_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    Zero1Optimizer,
    make_mesh,
    zero1_spec,
)
from multimodal_organ_segmentation_tpu_torch.parallel.multihost import (  # noqa: F401
    maybe_initialize_distributed,
    multihost_env_detected,
    resolve_distributed_args,
)
