"""Resident HTTP serving and the serving tuner of the PyTorch port."""

from multimodal_organ_segmentation_tpu_torch.serving.server import (
    InferenceService,
    RequestError,
    ServiceBusyError,
    make_server,
    run_serve,
)

__all__ = [
    "InferenceService",
    "RequestError",
    "ServiceBusyError",
    "make_server",
    "run_serve",
]
