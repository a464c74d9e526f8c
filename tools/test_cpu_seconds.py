#!/usr/bin/env python3
"""The CPU-seconds of each test file, each run alone in a pytest process.

    python3 tools/test_cpu_seconds.py [--root DIR] [--jobs 4]
        [--files 'tests/test_torch_*.py'] [--json FILE]

Runs ``python -m pytest -q -p no:cacheprovider -p no:randomly FILE`` from
``--root`` (default this checkout) with ``PYTHONPATH=<root>/src`` and
``JAX_PLATFORMS=cpu``, ``--jobs`` files at a time, the longest first when
``--json`` names an earlier run's record. Prints, per file, the user and
system CPU-seconds of its process and of the processes it waited for
(``os.wait4``), the wall seconds, the passes and the exit code; then the
totals. Compare two trees by running both back to back on one machine:
the CPU-seconds depend on what else the machine runs.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_file(root: Path, path: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", path], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = proc.stdout.read().decode(errors="replace")
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    passed = re.search(r"(\d+) passed", out)
    return dict(file=path, cpu_s=usage.ru_utime + usage.ru_stime,
                wall_s=time.perf_counter() - t0,
                passed=int(passed.group(1)) if passed else 0,
                rc=proc.returncode, tail=out.strip().splitlines()[-1:])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--files", default="tests/test_torch_*.py")
    p.add_argument("--json", default=None,
                   help="write the record here (read first for the order)")
    args = p.parse_args()
    root = Path(args.root).resolve()
    files = sorted(os.path.relpath(f, root)
                   for f in glob.glob(str(root / args.files)))
    if args.json and os.path.exists(args.json):
        with open(args.json) as f:
            last = {r["file"]: r["cpu_s"] for r in json.load(f)["files"]}
        files.sort(key=lambda f: -last.get(f, 1e9))
    todo, rows, lock = list(files), [], threading.Lock()

    def worker():
        while True:
            with lock:
                if not todo:
                    return
                path = todo.pop(0)
            row = run_file(root, path)
            with lock:
                rows.append(row)
                print(f"{row['cpu_s']:8.1f} CPU-s {row['wall_s']:7.1f} s "
                      f"{row['passed']:4d} passed rc {row['rc']} {path}",
                      flush=True)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(args.jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rows.sort(key=lambda r: r["file"])
    total = dict(cpu_s=sum(r["cpu_s"] for r in rows),
                 passed=sum(r["passed"] for r in rows), files=len(rows),
                 wall_s=time.perf_counter() - t0, jobs=args.jobs)
    print(f"total {total['cpu_s']:.1f} CPU-s, {total['passed']} passed in "
          f"{total['files']} files, {total['wall_s']:.1f} s on "
          f"{args.jobs} jobs")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(total=total, files=rows), f, indent=1)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
