#!/usr/bin/env python3
"""Kernel C on an NVIDIA GPU: the hand-written CUDA 3x3x3 convolution against
its plain PyTorch version and against cuDNN.

The counterpart of ``scripts/proto_conv_kernel.py``, with its two stages
(each line names the kernel route the plan gives the shape, ``f32`` or
``wgmma``; ``chip_smoke.py`` holds the launches to the plan):

1. correctness in f32 at ``[2, 16, 16, 16, 8] -> 8`` against the plain
   version (27 shifted matmuls summed in f32), max error below 1e-4;
2. bf16 at the two decoder shapes, ``[8, 96, 96, 96, 96] -> 48`` and
   ``[8, 96, 96, 96, 48] -> 48``: max error against the plain version (below
   2e-2 times the largest output: both round one f32 sum to bf16, and with
   the JAX script's weight scale the sums reach about 13, where one bf16
   ulp is 6.25e-2), then the kernel's time
   beside cuDNN's (``F.conv3d``, channels-last, a yardstick the port never
   calls) and the least time the card could take.

Run: python scripts/proto_conv_kernel_torch.py [--batch N]
Needs a CUDA device and nvcc; exits with code 2 without a device.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch
import torch.nn.functional as F

HBM_BYTES_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SHAPE_F32 = ((2, 16, 16, 16, 8), 8)  # (x shape, Cout)
SHAPES_BF16 = ((96, 48), (48, 48))  # (C, Cout) of x [BATCH, 96, 96, 96, C]
BATCH = 8
REPS = 5  # timed calls, after one warm-up


def make_inputs(shape, cout, dtype, seed, w_scale, device="cuda"):
    """Seeded x ``[B, D, H, W, C]`` and w ``[3, 3, 3, C, Cout]``, drawn on the
    device (the large shapes are gigabytes)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)
    w = (torch.randn((3, 3, 3, shape[-1], cout), generator=gen, device=device) * w_scale).to(dtype)
    return x, w


def conv_bound_ms(shape, cout, dtype):
    """(ms, "bytes" | "operations"): x and w read once, the output written
    once, against 2 * 27 * C * Cout flops per output voxel."""
    b, d, h, w, c = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = (b * d * h * w * (c + cout) + 27 * c * cout) * elt
    flops = 2 * 27 * b * d * h * w * c * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_conv(x, w):
    """cuDNN through ``F.conv3d`` on channels-last memory: views in, view out."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), padding=1).permute(0, 2, 3, 4, 1)


def event_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    if not torch.cuda.is_available():
        print("proto_conv_kernel_torch: no CUDA device", file=sys.stderr)
        return 2
    from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3, conv3x3x3_plain, plan

    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else BATCH
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)

    shape, cout = SHAPE_F32
    x, w = make_inputs(shape, cout, torch.float32, 0, 0.1)
    err = (conv3x3x3(x, w) - conv3x3x3_plain(x, w)).abs().max().item()
    print(f"f32 16^3 max err: {err:.2e} (route {plan(*shape, cout, x.dtype)['route']})", flush=True)
    assert err < TOL[torch.float32]

    for cin, cout in SHAPES_BF16:
        shape = (batch, 96, 96, 96, cin)
        x, w = make_inputs(shape, cout, torch.bfloat16, 1, 0.05)
        route = plan(*shape, cout, x.dtype)["route"]
        out = conv3x3x3(x, w)
        torch.cuda.synchronize()
        ref = conv3x3x3_plain(x, w).float()
        err = (out.float() - ref).abs().max().item()
        err_lib = (out.float() - library_conv(x, w).float()).abs().max().item()
        top = ref.abs().max().item()
        del ref
        print(f"bf16 {cin}->{cout} max |diff| vs plain: {err:.3e}, vs cuDNN: {err_lib:.3e} "
              f"(max |out| {top:.2f})", flush=True)
        assert err < TOL[torch.bfloat16] * max(1.0, top)
        flops = 2 * 27 * batch * 96**3 * cin * cout
        bound, by = conv_bound_ms(shape, cout, torch.bfloat16)
        for name, fn in ((f"kernel C conv3x3x3 ({route})", lambda: conv3x3x3(x, w)),
                         ("cuDNN F.conv3d channels-last", lambda: library_conv(x, w))):
            ms = event_ms(fn, REPS)
            print(f"{name:32s} {cin}->{cout} {ms:8.3f} ms  {flops / ms / 1e9:6.1f} TFLOP/s  "
                  f"(bound {bound:.3f} ms, {by})", flush=True)
        del x, w, out
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
