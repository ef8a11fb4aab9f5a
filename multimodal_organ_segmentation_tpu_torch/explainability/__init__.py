"""Explainability: GradCAM/GradCAM++, attention maps, t-SNE, gradient SHAP
and integrated gradients (port of the JAX package's ``explainability/``).

The JAX package reads activations from its models' ``capture`` API,
gradients from flax ``perturb`` variables and attention probabilities from
the sown ``intermediates``. The port's models take the same three as
arguments of ``forward`` (``capture``, ``perturb``, ``intermediates``), and
``torch.autograd.grad`` of a score with respect to the live activations
replaces the gradient of the zero perturbations. ``run_explainability`` is
the CLI's ``--mode explain``.
"""

from multimodal_organ_segmentation_tpu_torch.explainability.attention import (  # noqa: F401
    AttentionVisualizer,
)
from multimodal_organ_segmentation_tpu_torch.explainability.gradcam import (  # noqa: F401
    GradCAM,
    GradCAMPlusPlus,
    perturb_names,
    visualize_gradcam,
)
from multimodal_organ_segmentation_tpu_torch.explainability.runner import (  # noqa: F401
    run_explainability,
)
from multimodal_organ_segmentation_tpu_torch.explainability.shap_analysis import (  # noqa: F401
    SHAPAnalyzer,
)
from multimodal_organ_segmentation_tpu_torch.explainability.tsne import (  # noqa: F401
    TSNEVisualizer,
)
