"""Offline preprocessing: DICOM→NIfTI, SUV, registration, normalization
(port of the JAX package's ``preprocessing/``).

Reference parity: src/preprocessing/ (SURVEY.md §2.5). The DICOM codec,
the converter, SUV and the normalizer are the JAX package's numpy code,
copied, on the host; the spacing resample and the registration run on the
device (the card unless ``device="cpu"``), registration as ``torch.autograd``
gradient descent on image-similarity metrics.
"""

from multimodal_organ_segmentation_tpu_torch.preprocessing.dicom_converter import (  # noqa: F401
    DicomConverter,
)
from multimodal_organ_segmentation_tpu_torch.preprocessing.suv_calculator import (  # noqa: F401
    SUVCalculator,
)
from multimodal_organ_segmentation_tpu_torch.preprocessing.registration import (  # noqa: F401
    ImageRegistration,
)
from multimodal_organ_segmentation_tpu_torch.preprocessing.normalizer import (  # noqa: F401
    IntensityNormalizer,
)
