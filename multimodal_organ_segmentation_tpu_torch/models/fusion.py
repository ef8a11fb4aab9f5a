"""Cross-attention modality fusion (port of the JAX package's
``models/fusion.py::CrossAttentionFusion``).

Features are channels-last ``[B, H, W, D, C]``. The ring-attention branch
(sequence parallelism over a mesh axis) belongs to the multi-device slice
and is not ported yet; the other fusion strategies come with the other
models.
"""

from __future__ import annotations


import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.layers import Linear, instance_norm
from multimodal_organ_segmentation_tpu_torch.ops.attention import multi_head_attention


class CrossAttentionFusion(nn.Module):
    """Multi-head cross attention over flattened voxel tokens: query from one
    modality, key/value from the other; residual + instance norm.

    The q/k/v/out projections are the JAX package's 1x1x1 convs, held as
    ``Linear`` over the channel axis. Tokens go through
    ``multi_head_attention``: kernel B on the card, the blockwise plain
    version on the CPU or when ``use_kernel`` is False (``set_use_kernels``).
    """

    def __init__(self, channels: int, num_heads: int = 4, dropout: float = 0.0,
                 kv_block: int = 2048):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} must divide num_heads {num_heads}")
        self.num_heads = num_heads
        self.kv_block = kv_block
        self.use_kernel = True
        self.q_proj = Linear(channels, channels)
        self.k_proj = Linear(channels, channels)
        self.v_proj = Linear(channels, channels)
        self.out_proj = Linear(channels, channels)
        self.dropout = nn.Dropout(dropout)

    def forward(self, query_features: torch.Tensor, key_value_features: torch.Tensor) -> torch.Tensor:
        b, h, w, d, c = query_features.shape
        hd = c // self.num_heads
        n = h * w * d
        q = self.q_proj(query_features).reshape(b, n, self.num_heads, hd)
        k = self.k_proj(key_value_features).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(key_value_features).reshape(b, -1, self.num_heads, hd)
        out = multi_head_attention(q, k, v, kv_block=self.kv_block, use_kernel=self.use_kernel)
        out = self.dropout(self.out_proj(out.reshape(b, h, w, d, c)))
        y = instance_norm((query_features + out).permute(0, 4, 1, 2, 3))
        return y.permute(0, 2, 3, 4, 1)
