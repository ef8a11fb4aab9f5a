"""The port's SwinUNETR modules against their flax counterparts.

Each module that holds a kernel (``WindowAttention``, ``SwinBlock``,
``CrossAttentionFusion``) and the pieces around them get the same seeded
params (converted by ``models/convert.py``) and the same input, all on the
CPU in f32, where the port runs the kernels' plain versions.

Tolerances: 2e-5 for one attention or block (f32 sums in another order;
activations are O(1)); 1e-4 for the whole model, whose ~40 layers of convs
and norms add such differences up.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.models import fusion as jfusion
from multimodal_organ_segmentation_tpu.models import layers as jlayers
from multimodal_organ_segmentation_tpu.models import swin_unetr as jswin
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models import fusion as tfusion
from multimodal_organ_segmentation_tpu_torch.models import layers as tlayers
from multimodal_organ_segmentation_tpu_torch.models import swin_unetr as tswin
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from tests.torch_port_utils import as_np, no_tf32, port, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401

TOL = 2e-5
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shift", [False, True])
def test_window_attention(shift):
    dims, window = (12, 12, 6), (6, 6, 6)
    n, nw = 216, 4
    x = _normal((2 * nw, n, 24), 0)
    mask = None
    if shift:
        mask = np.asarray(jswin._shift_attention_mask(dims, window, (3, 3, 3)))
        np.testing.assert_array_equal(
            as_np(tswin._shift_attention_mask(dims, window, (3, 3, 3))), mask
        )
    flax_mod = jswin.WindowAttention(24, 3, window)
    variables = seeded_variables(flax_mod, x, mask, False, seed=1)
    ref = flax_mod.apply(variables, x, mask, False)

    mod = tswin.WindowAttention(24, 3, window)
    mod.load_state_dict(convert.window_attention_state(variables["params"]))
    out = mod(port(x), None if mask is None else port(mask))
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=TOL, atol=TOL)


def test_window_attention_bf16_precision_rule():
    """bf16: scores from an f32 product, then bias, mask and softmax in bf16
    (the JAX package's rule). 3e-2: the outputs reach |x| ~ 2, where one
    bf16 ulp is 7.8e-3, and the packages round the qkv, score, softmax and
    projection steps at different places, a few ulp apart."""
    dims, window = (12, 6, 6), (6, 6, 6)
    x = _normal((4, 216, 24), 20)
    mask = np.asarray(jswin._shift_attention_mask(dims, window, (3, 3, 3)))
    flax_mod = jswin.WindowAttention(24, 3, window, dtype=jnp.bfloat16)
    variables = seeded_variables(flax_mod, x, mask, False, seed=21)
    ref = flax_mod.apply(variables, jnp.asarray(x, jnp.bfloat16), mask, False)

    mod = tswin.WindowAttention(24, 3, window)
    mod.load_state_dict(convert.window_attention_state(variables["params"]))
    mod.qkv.to(torch.bfloat16)
    mod.proj.to(torch.bfloat16)
    out = mod(port(x, torch.bfloat16), port(mask))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(out), np.asarray(ref, np.float32), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize(
    "grid,window,shift",
    [
        ((12, 12, 12), (6, 6, 6), False),
        ((12, 12, 12), (6, 6, 6), True),
        ((10, 8, 9), (6, 6, 6), True),  # padded to window multiples, then rolled
        ((4, 4, 4), (6, 6, 6), True),  # window clamps to the grid: no shift
    ],
)
def test_swin_block(grid, window, shift):
    x = _normal((1, *grid, 24), 2)
    flax_mod = jswin.SwinBlock(24, 3, window, shift=shift)
    variables = seeded_variables(flax_mod, x, False, seed=3)
    ref = flax_mod.apply(variables, x, False)

    mod = tswin.SwinBlock(24, 3, window, grid, shift=shift)
    mod.load_state_dict(convert.swin_block_state(variables["params"]))
    np.testing.assert_allclose(as_np(mod(port(x))), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv_block", [2048, 100])
def test_cross_attention_fusion(kv_block):
    """kv_block 100 < 216 tokens takes the blockwise recurrence in both."""
    xq, xkv = _normal((2, 6, 6, 6, 32), 4), _normal((2, 6, 6, 6, 32), 5)
    flax_mod = jfusion.CrossAttentionFusion(num_heads=2, kv_block=kv_block)
    variables = seeded_variables(flax_mod, xq, xkv, False, seed=6)
    ref = flax_mod.apply(variables, xq, xkv, False)

    mod = tfusion.CrossAttentionFusion(32, num_heads=2, kv_block=kv_block)
    mod.load_state_dict(convert.cross_attention_fusion_state(variables["params"]))
    np.testing.assert_allclose(
        as_np(mod(port(xq), port(xkv))), np.asarray(ref), rtol=TOL, atol=TOL
    )


def test_patch_merging():
    x = _normal((2, 5, 4, 6, 8), 7)  # an odd side pads
    flax_mod = jswin.PatchMerging(8)
    variables = seeded_variables(flax_mod, x, seed=8)
    ref = flax_mod.apply(variables, x)
    mod = tswin.PatchMerging(8)
    sd = {}
    convert._layer_norm(sd, "norm", variables["params"]["LayerNorm_0"])
    convert._dense(sd, "reduction", variables["params"]["Dense_0"])
    mod.load_state_dict(sd)
    np.testing.assert_allclose(as_np(mod(port(x))), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("norm", ["instance", "group", "none"])
def test_norm3d(norm):
    x = 3.0 + 2.0 * _normal((2, 4, 5, 6, 16), 9)  # channels-last, as flax takes it
    flax_mod = jlayers.Norm3D(norm)
    variables = seeded_variables(flax_mod, x, False, seed=10) if norm == "group" else {}
    ref = flax_mod.apply(variables, x, False)
    mod = tlayers.Norm3D(norm, 16)
    if norm == "group":
        gn = variables["params"]["GroupNorm_0"]
        mod.load_state_dict({"weight": port(gn["scale"]), "bias": port(gn["bias"])})
    out = mod(port(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=TOL, atol=TOL)


def test_norm3d_batch_uses_running_statistics():
    mod = tlayers.Norm3D("batch", 4).eval()
    x = torch.randn(2, 4, 3, 3, 3)
    torch.testing.assert_close(mod(x), x / (1 + 1e-5) ** 0.5)
    with pytest.raises(ValueError):
        tlayers.Norm3D("layer", 4)


def test_divisor_heads_and_shift_rules():
    for c in (96, 192, 320, 384, 768, 7):
        assert tswin._divisor_heads(c, 96) == jswin._divisor_heads(c, 96)
    assert tswin._shift_for((6, 6, 6), (48, 48, 48)) == (3, 3, 3)
    assert tswin._shift_for((6, 6, 6), (6, 6, 6)) == (0, 0, 0)
    for window in ((6, 6, 6), (4, 3, 2), (7, 7, 7)):
        np.testing.assert_array_equal(
            tswin._relative_position_index(window), jswin._relative_position_index(window)
        )


def test_window_partition_order():
    """Batch-major, windows fastest: kernel A indexes the mask with bw % nW."""
    x = _normal((2, 12, 6, 6, 3), 11)
    ref = np.asarray(jswin.window_partition(jnp.asarray(x), (6, 6, 6)))
    out = tswin.window_partition(port(x), (6, 6, 6))
    np.testing.assert_array_equal(as_np(out), ref)
    back = tswin.window_unpartition(out, (6, 6, 6), (2, 12, 6, 6))
    np.testing.assert_array_equal(as_np(back), x)


def _model_config(scan_blocks=False, fs=12, img=32):
    return {
        "experiment": {"seed": 0},
        "data": {"modalities": ["CT", "PET"]},
        "model": {
            "name": "swin_unetr", "in_channels": 2, "out_channels": 8,
            "backbone": {"img_size": [img] * 3, "feature_size": fs, "depths": [2, 2, 2, 2],
                         "num_heads": [3, 6, 12, 24], "window_size": [6, 6, 6],
                         "scan_blocks": scan_blocks},
            "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
            "head": {"type": "conv", "dropout": 0.0},
        },
        "hardware": {"mixed_precision": "fp32"},
    }


def test_whole_model_forward_matches_flax():
    """One 32³ tile through the flagship structure at fs=12."""
    x = _normal((1, 32, 32, 32, 2), 12)
    flax_mod = jswin.build_swin_unetr(_config_node(_model_config()))
    variables = seeded_variables(flax_mod, x, train=False, seed=13)
    ref = jax.jit(lambda v, x: flax_mod.apply(v, x, train=False))(variables, x)

    model = build_model(_model_config(), device="cpu")
    model.load_state_dict(convert.swin_unetr_params_from_jax(variables))
    with torch.no_grad():
        out = model(port(x))
    assert out.dtype == torch.float32 and out.shape == (1, 32, 32, 32, 8)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_scan_tree_converts_to_the_unrolled_state():
    """The scan_blocks tree stacks each stage's blocks on a depth axis; its
    conversion equals the conversion of the same values unrolled."""
    x = np.zeros((1, 32, 32, 32, 2), np.float32)
    scan_mod = jswin.build_swin_unetr(_config_node(_model_config(scan_blocks=True)))
    scan = seeded_variables(scan_mod, x, train=False, seed=14)["params"]
    unrolled = {k: v for k, v in scan.items() if not k.startswith("stage")}
    for s in range(4):
        for b in range(2):
            unrolled[f"stage{s}_block{b}"] = jax.tree_util.tree_map(
                lambda a: a[b], scan[f"stage{s}"]["blocks"]
            )
    a = convert.swin_unetr_params_from_jax(scan)
    b = convert.swin_unetr_params_from_jax(unrolled)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_unported_options_raise(tmp_path):
    """Tensor parallelism raises; monai_compat builds
    (``test_torch_reference_checkpoint.py``) but, as the JAX ``build_swin_unetr``,
    refuses this flagship's cross-attention fusion; deep supervision builds
    (``test_deep_supervision_matches_flax``), and so does every other model
    of the registry: only an unknown name raises. ``model.enable_perturb``
    builds and is ignored: the same points, the state dict has the same keys
    as without it, and a checkpoint written from a model without it loads."""
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    for key, value in (("monai_compat", True),):
        cfg = _model_config()
        cfg["model"]["backbone"][key] = value
        with pytest.raises(ValueError, match="cross_attention"):
            build_model(cfg, device="cpu")
    cfg = _model_config()
    plain = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    save_checkpoint({"step": 0, "params": plain.state_dict(), "opt_state": None,
                     "ema_params": None}, tmp_path / "ckpt")
    cfg["model"]["enable_perturb"] = True
    model = build_model(cfg, device="cpu")
    assert model.perturb_points == plain.perturb_points == [f"stage{i}" for i in range(5)]
    assert list(model.state_dict()) == list(plain.state_dict())
    model.load_state_dict(load_checkpoint(tmp_path / "ckpt")["tree"]["params"])
    for key, value in plain.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    cfg = _model_config()
    cfg["parallel"] = {"mesh": {"data": 1, "model": 2}}
    # one process: the whole model, as the JAX model runs outside a mesh
    tp = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert getattr(tp, "tp", None) is None
    assert {k: v.shape for k, v in tp.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    cfg = _model_config()
    cfg["model"]["name"] = "unet4d"
    with pytest.raises(ValueError, match="Unknown model"):
        build_model(cfg, device="cpu")


def test_deep_supervision_matches_flax():
    """``model.head.type: deep_supervision``: in training the logits and the
    /2 and /4 aux heads upsampled to the tile, as the flax model returns
    them; in eval the logits alone."""
    cfg = _model_config()
    cfg["model"]["head"]["type"] = "deep_supervision"
    x = _normal((1, 32, 32, 32, 2), 15)
    flax_mod = jswin.build_swin_unetr(_config_node(cfg))
    variables = seeded_variables(flax_mod, x, train=False, seed=16)
    assert {"ds_head0", "ds_head1"} <= set(variables["params"])
    ref = jax.jit(lambda v, x: flax_mod.apply(v, x, train=True))(variables, x)

    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(convert.swin_unetr_params_from_jax(variables))
    with torch.no_grad():
        outs = model(port(x))
        assert len(outs) == len(ref) == 3
        for out, r in zip(outs, ref):
            assert out.dtype == torch.float32 and out.shape == (1, 32, 32, 32, 8)
            np.testing.assert_allclose(as_np(out), np.asarray(r), rtol=MODEL_TOL, atol=MODEL_TOL)
        logits = model.eval()(port(x))
    np.testing.assert_array_equal(as_np(logits), as_np(outs[0]))
    back = convert.swin_unetr_params_to_jax(model.state_dict())
    np.testing.assert_array_equal(back["ds_head1"]["kernel"], variables["params"]["ds_head1"]["kernel"])


def _config_node(d):
    from multimodal_organ_segmentation_tpu.utils.config import ConfigNode

    return ConfigNode(d)
