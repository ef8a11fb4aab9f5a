"""CPU-seconds of the port's test files, one pytest process a file.

    python tests/port_test_clock.py [--jobs 2] [--out clock.json] [FILE ...]
    python tests/port_test_clock.py --against OTHER_CHECKOUT [--other-first] [--out pair.json]

Runs each port test file (``tests/test_torch_*.py`` that imports the port:
``test_torch_export.py`` and ``test_torch_import.py`` test the JAX package's
own torch interop), or the files given, alone under
``pytest -q -m 'not slow' --durations=0`` from the repository root that
holds this script, and reads the user + system CPU time of the process and
every child it waited for (spawned ranks, ``torchrun`` launches) from
``os.wait4``. Prints one line a file, then the total; ``--out`` also writes
them as JSON with each file's ten slowest durations.

With ``--against``, one pair a file: the file of this checkout and the same
file of the other (say, an archive of the parent commit) run at the same
time, so both see the same load on the box; ``--other-first`` starts the
other side first (alternate it between rounds). A file that only one side
has runs alone.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_one(path: str, root: Path = ROOT) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", path, "-q", "-m", "not slow", "-p", "no:cacheprovider",
         "-p", "no:randomly", "--durations=0"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = proc.stdout.read()
    _, status, usage = os.wait4(proc.pid, 0)
    wall = time.perf_counter() - start
    lines = out.splitlines()
    durations = [ln for ln in lines if ln[:1].isdigit() and "s " in ln[:12]][:10]
    return {"file": path, "rc": os.waitstatus_to_exitcode(status),
            "cpu_s": round(usage.ru_utime + usage.ru_stime, 1), "wall_s": round(wall, 1),
            "summary": lines[-1] if lines else "", "slowest": durations}


def port_files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in (root / "tests").glob("test_torch_*.py")
                  if "multimodal_organ_segmentation_tpu_torch" in p.read_text())


def paired(other: Path, other_first: bool, only: list) -> list:
    """Each file of this checkout and of ``other`` at the same time."""
    sides = {"this": (ROOT, port_files(ROOT)), "other": (other, port_files(other))}
    order = ["other", "this"] if other_first else ["this", "other"]
    rows = []
    with ThreadPoolExecutor(2) as pool:
        for f in sorted(set(sides["this"][1]) | set(sides["other"][1])):
            if only and f not in only:
                continue
            futures = {side: pool.submit(run_one, f, sides[side][0])
                       for side in order if f in sides[side][1]}
            row = {"file": f, **{side: fut.result() for side, fut in futures.items()}}
            print(f, {side: (r["cpu_s"], r["rc"]) for side, r in row.items() if side != "file"},
                  flush=True)
            rows.append(row)
    for side in ("this", "other"):
        total = round(sum(r[side]["cpu_s"] for r in rows if side in r), 1)
        print(f"{total:8.1f} cpu-s {side}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--against", help="another checkout whose files run beside these, paired")
    ap.add_argument("--other-first", action="store_true")
    args = ap.parse_args(argv)
    if args.against:
        rows = paired(Path(args.against).resolve(), args.other_first, args.files)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return
    files = args.files or port_files(ROOT)
    with ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(run_one, files))
    for r in rows:
        print(f"{r['cpu_s']:8.1f} cpu-s {r['wall_s']:7.1f} s rc {r['rc']}  {r['file']}  "
              f"{r['summary']}")
    total = round(sum(r["cpu_s"] for r in rows), 1)
    print(f"{total:8.1f} cpu-s in {len(rows)} files")
    if args.out:
        Path(args.out).write_text(json.dumps({"total_cpu_s": total, "files": rows}, indent=1))


if __name__ == "__main__":
    main()
