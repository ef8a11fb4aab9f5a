"""Time the serving and training paths of two checkouts of this repo on one
NVIDIA GPU, in turns: base, change, change, base.

    python3 scripts/ab_paths.py BASE_DIR [CHANGE_DIR]

CHANGE_DIR defaults to this checkout. Each turn runs, in a fresh process at
that checkout's root, its own ``chip_smoke.py`` build, serve and train
phases (the same volumes, steps and checks as the smoke test, no profiler)
and prints their summary lines tagged with the checkout. The card's name
and power limit come last. Exits non-zero without a CUDA device or if any
turn fails.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

TURN = ("import sys; sys.path.insert(0, '.'); import chip_smoke as c; c.phase_build(); "
        "c.phase_serve(False); c.phase_train(False)")
KEEP = ("[serve] volume", "[serve] kernels", "[train] micro-batch", "[train] kernels",
        "[train] f32 step")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_paths: no CUDA device", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    base = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else Path(__file__).resolve().parents[1]
    for label, root in (("base", base), ("change", change), ("change", change), ("base", base)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith(KEEP):
                print(f"[{label}] {line}", flush=True)
        if proc.returncode != 0:
            print(f"[{label}] failed with code {proc.returncode}:\n{proc.stderr[-4000:]}",
                  flush=True)
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
