"""Clinical analysis tail: SUV, TMTV/TLG, histograms, reports (port of the
JAX package's ``analysis/``).

The statistics run on tensors on the configured device (the card unless the
caller names another), in float64 as the JAX package's numpy reads the
volumes; file discovery, figures and the table and report writers stay on
the host. Thresholding semantics as the JAX package's, including the
``(seg == 0) | (seg > 7)`` tumour region and the label-5 liver rule.
"""

from multimodal_organ_segmentation_tpu_torch.analysis.histogram import (  # noqa: F401
    HistogramAnalyzer,
)
from multimodal_organ_segmentation_tpu_torch.analysis.report import (  # noqa: F401
    ReportGenerator,
)
from multimodal_organ_segmentation_tpu_torch.analysis.suv import (  # noqa: F401
    ORGAN_LABELS,
    SUVAnalyzer,
)
from multimodal_organ_segmentation_tpu_torch.analysis.tmtv import TMTVAnalyzer  # noqa: F401
