"""Build the CUDA sources under ``csrc/`` into one shared library.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (a build of seconds; sources
that include PyTorch's headers take minutes). The library lands in
``build/repro_torch/<hash>/`` under the repository root (git-ignored), keyed
by a hash of the sources and flags, and is built at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "launch_select_events": [_P, _P, _P, _I, _I, _I, _I, _P],
    "launch_group_by_kind": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "launch_trace_rank": [_P, _P, _I, _I, _P],
    "launch_route_rank": [_P, _P, _I, _I, _I, _P],
    "launch_ring_slots": [_P, _P, _P, _P, _I, _I, _I, _P],
    "launch_fused_select": [_P] * 27 + [_I] * 7 + [_P],
    "max_keys": [],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libevent_select.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libevent_select.{os.getpid()}.tmp.so"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      log=log)
    _lib = lib
    return lib
