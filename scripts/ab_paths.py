"""Time two checkouts of this repo on one NVIDIA GPU, in turns: base,
change, change, base.

    python3 scripts/ab_paths.py [--kernels] BASE_DIR [CHANGE_DIR]

CHANGE_DIR defaults to this checkout. Each turn runs, in a fresh process at
that checkout's root and with that checkout's package (the turn fails if
the package is imported from anywhere else), its own ``chip_smoke.py``
build and then:

- by default, the serve and train phases (the same volumes, steps and
  checks as the smoke test, no profiler), printing their summary lines;
- with ``--kernels``, the kernels phase, printing each kernel's ms, its
  plain version's and the library call's (bf16, summed over the path's unit
  of work, as the ``kernels`` JSON line gives them). Both sides are timed with CHANGE_DIR's ``chip_smoke.gpu_time``,
  loaded from its file, so that the yardstick is the same. Then the host
  time of one call of CHANGE_DIR's ``window_mha`` (the custom op) and of its
  bare launch (``_launch``) on a small bf16 input.

Each line is tagged with its checkout. The card's name and power limit come
last. Exits non-zero without a CUDA device or if any turn fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

PACKAGE = "multimodal_organ_segmentation_tpu_torch"

# {timing}: the chip_smoke.py whose gpu_time times both sides, or "" for the
# turn's own; {phases}: the phases to run after the build
TURN = """
import importlib.util, json, sys
from pathlib import Path
import torch
sys.path.insert(0, '.')
import chip_smoke as c
if {timing!r}:
    spec = importlib.util.spec_from_file_location('ab_timing', {timing!r})
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    c.gpu_time = timing.gpu_time
c.phase_build()
import {package} as package
if Path(package.__file__).resolve().parent != (Path.cwd() / '{package}').resolve():
    sys.exit('ab_paths: {package} came from ' + package.__file__ + ', not from ' + str(Path.cwd()))
{phases}
"""
PATHS = "c.phase_serve(False); c.phase_train(False)"
KERNELS = ("summary = c.phase_kernels(torch.empty(256 * 2**20, dtype=torch.uint8, device='cuda'))\n"
           "print('KERNELS ' + json.dumps({name: {k: s[k] for k in ('ms', 'plain_ms', 'library_ms')}\n"
           "                               for name, s in summary.items()}))")
KEEP_PATHS = ("[serve] volume", "[serve] kernels", "[train] micro-batch", "[train] kernels",
              "[train] f32 step")

DISPATCH = """
import time
import torch
from multimodal_organ_segmentation_tpu_torch.ops import window_attention as wa

x = torch.randn(8, 216, 3, 16, device='cuda', dtype=torch.bfloat16)
bias = torch.randn(3, 216, 216, device='cuda')


def host_us(fn, n=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


print('window_mha host us a call: custom op %.1f, bare launch %.1f' % (
    host_us(lambda: wa.window_mha(x, x, x, bias, None, 1)),
    host_us(lambda: wa._launch(x, x, x, bias, None, 1))))
"""


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_paths: no CUDA device", file=sys.stderr)
        return 2
    kernels = "--kernels" in argv
    argv = [a for a in argv if a != "--kernels"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else Path(__file__).resolve().parents[1]
    turn = TURN.format(timing=str(change / "chip_smoke.py") if kernels else "", package=PACKAGE,
                       phases=KERNELS if kernels else PATHS)
    keep = ("KERNELS ",) if kernels else KEEP_PATHS
    for label, root in (("base", base), ("change", change), ("change", change), ("base", base)):
        proc = subprocess.run([sys.executable, "-c", turn], cwd=root, capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(keep):
                print(f"[{label}] {line}", flush=True)
        if proc.returncode != 0:
            print(f"[{label}] failed with code {proc.returncode}:\n{proc.stderr[-4000:]}",
                  flush=True)
            return 1
    rc = 0
    if kernels:
        proc = subprocess.run([sys.executable, "-c", DISPATCH], cwd=change, capture_output=True,
                              text=True)
        print(proc.stdout.strip() or proc.stderr[-4000:], flush=True)
        rc = proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
