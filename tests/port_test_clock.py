"""CPU-seconds of the port's test files, one pytest process a file.

    python tests/port_test_clock.py [--jobs 2] [--out clock.json] [FILE ...]
    python tests/port_test_clock.py --against OTHER_CHECKOUT [--other-first] [--out pair.json]
    python tests/port_test_clock.py --queue [clock.json]
    python tests/port_test_clock.py --junit run.xml

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

With ``--queue``, the order in which the suite's ``-n 6 --dist loadfile``
hands out its files: every file of ``tests/`` by its number of tests
collected under ``-m 'not slow'``, most first, ties in collection order
(xdist's ``LoadScopeScheduling.schedule``). Each file is marked ahead of or
behind ``CRITICAL``, the file that sets the suite's wall time, and shown
with its CPU-seconds where a JSON that ``--out`` wrote is given.

With ``--junit``, the suite's wall in three parts, replayed from the test
times of a run's ``--junitxml``: S, when ``CRITICAL`` starts; T, its own
time; F, the file its worker takes while its last two tests are pending,
which then waits behind them. The replay hands out files as xdist's
``loadfile`` does (one file to each worker, then one more to a worker
whenever two or fewer of its tests are pending) and leaves out the
workers' start and collection, so its end falls short of the run's wall
by about that much.
"""

import argparse
import heapq
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CRITICAL = "tests/test_swin_import.py"


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


def collected(root: Path = ROOT) -> list:
    """(file, number of tests) for every file of ``tests/`` that collects
    any, in collection order, as the suite's command selects them."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", "--continue-on-collection-errors"],
        cwd=root, env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True).stdout
    return count_nodeids(out.splitlines())


def count_nodeids(lines) -> list:
    """(file, number of node ids) in order of first appearance, from the
    lines of ``pytest --collect-only -q``."""
    counts = {}
    for line in lines:
        if "::" in line and not line.startswith(" "):
            f = line.split("::", 1)[0]
            counts[f] = counts.get(f, 0) + 1
    return list(counts.items())


def loadfile_order(counts: list) -> list:
    """xdist's ``loadfile`` queue of ``(file, number of tests)`` in
    collection order: most tests first, ties in collection order."""
    return sorted(counts, key=lambda fc: -fc[1])


def _cpu_by_file(path: str) -> dict:
    """File → CPU-seconds from a JSON that ``--out`` wrote (this side of a pair)."""
    data = json.loads(Path(path).read_text())
    rows = data["files"] if isinstance(data, dict) else [r["this"] for r in data if "this" in r]
    return {r["file"]: r["cpu_s"] for r in rows}


def queue(clock: str = "") -> list:
    """Print the loadfile queue, each file ahead of or behind ``CRITICAL``."""
    cpu = _cpu_by_file(clock) if clock else {}
    order = loadfile_order(collected())
    files = [f for f, _ in order]
    at = files.index(CRITICAL) if CRITICAL in files else len(files)
    sums = {"ahead": 0.0, "behind": 0.0}
    for i, (f, n) in enumerate(order):
        where = "ahead" if i < at else "behind" if i > at else "CRITICAL"
        if f in cpu and where in sums:
            sums[where] += cpu[f]
        shown = f"{cpu[f]:8.1f}" if f in cpu else " " * 8
        print(f"{i + 1:3d} {n:4d} tests {where:8s} {shown}  {f}")
    if cpu:
        print(f"port cpu-s ahead {sums['ahead']:.1f}, behind {sums['behind']:.1f}")
    return order


def junit_times(path: str) -> dict:
    """File → its tests' times (setup, call and teardown) from a junit XML,
    in the order they ran (one worker runs a file)."""
    times = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        f = "/".join(case.get("classname", "").split(".")[:2]) + ".py"
        times.setdefault(f, []).append(float(case.get("time", 0.0)))
    return times


def replay(times: dict, workers: int = 6, critical: str = CRITICAL) -> dict:
    """xdist's ``loadfile`` schedule of ``times`` (file → test times; files
    in collection order, pytest's sorted names) on ``workers`` workers:
    each file's worker, start and end, the run's end, and S, T and F (the
    files handed to the critical file's worker while its tests are pending,
    with their time)."""
    queue = [f for f, _ in loadfile_order([(f, len(times[f])) for f in sorted(times)])]
    todo = {w: [] for w in range(workers)}  # tests handed to a worker, not yet done
    files, clock, behind = {}, [0.0] * workers, []

    def hand_out(w):
        f = queue.pop(0)
        files[f] = {"worker": w, "start": None, "end": None}
        todo[w].extend((f, t) for t in times[f])

    for w in range(workers):
        if queue:
            hand_out(w)
    for w in range(workers):
        if queue and len(todo[w]) <= 2:
            hand_out(w)
    running = []
    for w in range(workers):
        if todo[w]:
            f, t = todo[w][0]
            files[f]["start"] = 0.0
            heapq.heappush(running, (t, w))
    while running:
        now, w = heapq.heappop(running)
        f, _ = todo[w].pop(0)
        files[f]["end"] = now
        clock[w] = now
        if queue and len(todo[w]) <= 2:
            if any(g == critical for g, _ in todo[w]):
                behind.append(queue[0])
            hand_out(w)
        if todo[w]:
            g, t = todo[w][0]
            if files[g]["start"] is None:
                files[g]["start"] = now
            heapq.heappush(running, (now + t, w))
    return {"files": files, "end": max(clock),
            "S": files.get(critical, {}).get("start"), "T": sum(times.get(critical, [])),
            "F": (behind, sum(sum(times[f]) for f in behind))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--against", help="another checkout whose files run beside these, paired")
    ap.add_argument("--other-first", action="store_true")
    ap.add_argument("--queue", nargs="?", const="", metavar="CLOCK_JSON",
                    help="print the loadfile queue; CPU-s from a JSON that --out wrote")
    ap.add_argument("--junit", help="S, T and F of a run, replayed from its --junitxml")
    args = ap.parse_args(argv)
    if args.queue is not None:
        queue(args.queue)
        return
    if args.junit:
        r = replay(junit_times(args.junit))
        print(f"S {r['S']:.1f} s  T {r['T']:.1f} s  F {r['F'][1]:.1f} s "
              f"({', '.join(r['F'][0]) or 'none'})  replayed end {r['end']:.1f} s")
        return
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
