"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own into
a shared library under ``build/kernels/`` at the repository root (git
ignores ``build/``). A library is named after a hash of its source, every
shared header (``csrc/*.cuh``) and the compile and link flags, so an edited
source or header rebuilds and an unchanged one loads at once.
:func:`build_all` starts one ``nvcc`` per source, all together; the
longest (``SPLIT_COMPILE``) also optimises its parts in parallel threads.

Every ``nvcc`` build is recorded in the build ledger
(:func:`~perceiver_io_tpu_torch.observability.default_ledger`) at site
``kernel_build``: the source is its identity, the library's 12-hex hash and
the flags its components, the ``nvcc`` wall time its ``compile_ms``. A
library loaded from ``build/kernels/`` as it is records nothing.

Nothing here runs at import time: the first call of a kernel's wrapper
builds its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared", "-Xcompiler", "-fPIC"]
#: sources ``nvcc`` compiles with its split compile (the translation unit
#: cut into parts optimised in parallel threads, as many as there are
#: cores): the longest build, whose kernels' machine code is the same
#: either way (``time_build.py``)
SPLIT_COMPILE = ("flash_attention_bwd_tf32",)
SPLIT_FLAGS = ["-split-compile=0"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: monotonic start time of each ``nvcc`` in flight, by source
_STARTED: Dict[str, float] = {}
#: ``nvcc`` output (``-Xptxas -v``: registers, shared memory, spills) by source
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _flags(name: str) -> List[str]:
    """The compile and link flags of ``csrc/<name>.cu``."""
    return [*NVCC_FLAGS, *(SPLIT_FLAGS if name in SPLIT_COMPILE else []), *LINK_FLAGS]


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start compiling ``csrc/<name>.cu`` unless its library is built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    _STARTED[name] = time.monotonic()
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _record(name: str, out: Path, wall_s: float) -> None:
    """One ``kernel_build`` record in the build ledger."""
    from perceiver_io_tpu_torch.observability import default_ledger

    default_ledger().record_build(
        "kernel_build",
        {"source": f"csrc/{name}.cu", "hash": out.stem.rsplit("-", 1)[1],
         "flags": " ".join(_flags(name))},
        wall_s * 1e3,
    )


def _finish(name: str, proc: Optional[subprocess.Popen],
            done: Optional[tuple] = None) -> None:
    """Wait for ``nvcc`` (``done``: its output and the instant it ended, when
    a reader thread already waited), install the library, record the build."""
    if proc is None:
        return
    log, ended = done if done is not None else (proc.communicate()[0], time.monotonic())
    wall_s = ended - _STARTED.pop(name)
    BUILD_LOG[name] = log
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    _record(name, out, wall_s)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> None:
    """Build every kernel library, one ``nvcc`` process per source in parallel."""
    with _LOCK:
        procs = {name: _start(name) for name in sources()}
        done: Dict[str, tuple] = {}

        def wait(name: str, proc: subprocess.Popen) -> None:
            # one reader per build: each build's own wall time, though they
            # run together (and no pipe fills while another is waited on)
            done[name] = (proc.communicate()[0], time.monotonic())

        readers = [threading.Thread(target=wait, args=(name, proc))
                   for name, proc in procs.items() if proc is not None]
        for t in readers:
            t.start()
        for t in readers:
            t.join()
        for name, proc in procs.items():
            _finish(name, proc, done.get(name))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib
