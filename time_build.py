#!/usr/bin/env python3
"""Wall and CPU time of the kernel build, as ``chip_smoke.py``'s build phase
runs it, with and without ``nvcc``'s split compile:

    python3 time_build.py                          # unsplit, split, split, unsplit
    python3 time_build.py --split all              # split every source
    python3 time_build.py --split flash_attention_fwd_wide_mma flash_attention_bwd_wide_mma

Each build compiles every ``csrc/*.cu`` into a fresh directory under
``build/time_build/``, one ``nvcc`` per source, all started together, as
``_build.build_all`` does. The ``unsplit`` builds take the package's flags
without a split compile (``_build.NVCC_FLAGS``, ``_build.LINK_FLAGS``); the
``split`` builds add ``_build.SPLIT_FLAGS`` (``nvcc`` cuts the translation
unit into parts it optimises in parallel threads, as many as the machine
has cores) to the sources named by ``--split`` (by default
``_build.SPLIT_COMPILE``, the package's own build). The builds run in the
order A B B A: each twice.

Prints the machine (``nvidia-smi`` name and power limit, the cores this
process may use, ``nvcc --version``'s last line) as a JSON line, then one
JSON line per build: its wall seconds, each source's ``nvcc`` wall, the CPU
seconds of every ``nvcc`` and what it ran (user + system, from
``getrusage(RUSAGE_CHILDREN)``), that CPU time over the cores (no build of
the same work on these cores ends sooner), and the sources whose kernels
differ from the first build's: in their ``ptxas`` lines (registers,
spills, shared memory) and in their machine code (``cuobjdump -sass``, each
function's listing).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _children_cpu_s() -> float:
    usage = resource.getrusage(resource.RUSAGE_CHILDREN)
    return usage.ru_utime + usage.ru_stime


def ptxas(log: str) -> list:
    """Each kernel instance's ``ptxas`` usage line (registers, spills,
    shared memory), by its mangled name, from ``-Xptxas -v``."""
    out, entry = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = found.group(1)
        elif entry and "Used" in line and "registers" in line:
            out.append((entry, line.split("ptxas info    :")[-1].strip()))
    return sorted(out)


def sass(nvcc: str, lib: Path) -> dict:
    """A digest of each function's SASS in ``lib`` (``cuobjdump -sass``;
    its addresses count from the function's start)."""
    text = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = hashlib.sha256(body.encode()).hexdigest()[:16]
    return out


def build(out_dir: Path, extra: dict) -> dict:
    """Every source into ``out_dir``, one ``nvcc`` each, all at once; the
    sources in ``extra`` take those flags as well."""
    from perceiver_io_tpu_torch import _build

    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cpu0 = _children_cpu_s()
    t0 = time.monotonic()
    procs = {}
    for name in _build.sources():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra.get(name, []), *_build.LINK_FLAGS,
               "-o", str(out_dir / f"{name}.so"), str(_build.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ended, logs = {}, {}

    def wait(name):
        logs[name] = procs[name].communicate()[0]
        ended[name] = time.monotonic()

    readers = [threading.Thread(target=wait, args=(n,)) for n in procs]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    wall = time.monotonic() - t0
    failed = {n: logs[n][-2000:] for n, p in procs.items() if p.returncode != 0}
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    cpu = _children_cpu_s() - cpu0
    cores = len(os.sched_getaffinity(0))
    return {"wall_s": wall, "cpu_s": cpu, "cores": cores, "cpu_s_over_cores": cpu / cores,
            "source_wall_s": {n: ended[n] - t0 for n in sorted(procs)},
            "longest": max(procs, key=lambda n: ended[n]),
            "code": {n: (ptxas(logs[n]), sass(_build._nvcc(), out_dir / f"{n}.so")) for n in procs}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--split", nargs="+", default=None,
                        help="the sources the split builds split (all: every source; by default "
                             "_build.SPLIT_COMPILE)")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from perceiver_io_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "cores": len(os.sched_getaffinity(0)),
                      "nvcc": nvcc.splitlines()[-1] if nvcc else None}), flush=True)
    split = (_build.SPLIT_COMPILE if args.split is None else _build.sources() if args.split == ["all"]
             else args.split)
    variants = {"unsplit": {}, "split": {n: _build.SPLIT_FLAGS for n in split}}
    first = None
    for i, variant in enumerate(("unsplit", "split", "split", "unsplit")):
        rec = build(ROOT / "build" / "time_build" / f"{i}_{variant}", variants[variant])
        code = rec.pop("code")
        first = first or code
        # the code each kernel became against the first build's
        rec["ptxas_differs"] = sorted(n for n in code if code[n][0] != first[n][0])
        rec["sass_differs"] = sorted(n for n in code if code[n][1] != first[n][1])
        rec["sass_functions"] = sum(len(c[1]) for c in code.values())
        print(json.dumps({"build": i, "variant": variant, "flags": variants[variant], **rec}), flush=True)
    shutil.rmtree(ROOT / "build" / "time_build", ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
