"""Build the CUDA sources under ``csrc/`` into shared libraries.

``nvcc`` compiles each ``csrc/<name>.cu`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (a build of seconds;
sources that include PyTorch's headers take minutes). The first call builds
every source at once, one ``nvcc`` process each, started together. Each
library lands in ``build/repro_torch/<name>-<hash>/`` under the repository
root (git-ignored), keyed by a hash of its source and the flags.
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
    "event_select": {
        "launch_select_events": [_P, _P, _P, _I, _I, _I, _I, _P],
        "launch_group_by_kind": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
        "launch_trace_rank": [_P, _I, _P, _I, _I, _P],
        "launch_route_rank": [_P, _P, _I, _I, _I, _P],
        "launch_ring_slots": [_P, _P, _P, _P, _I, _I, _I, _P],
        "launch_fused_select": [_P] * 27 + [_I] * 7 + [_P],
        "max_keys": [],
    },
    "bandwidth_share": {
        "launch_maxmin_rates": [_P, _P, _P, _P, _I, _I, _I, _I]
                               + [ctypes.c_ulonglong] * 4 + [_I, _I, _I, _P],
        "maxmin_smem_bytes": [_I, _I],
        "maxmin_max_smem": [],
        "maxmin_max_order_blocks": [],
        "maxmin_takes_warp": [_I, _I],
        "maxmin_warp_blocks_per_sm": [],
    },
    "flash_attention": {
        "launch_flash_attention": [_P] * 4 + [_I] * 8 + [_P],
    },
    "rwkv6_scan": {
        "launch_gla_scan": [_P] * 7 + [_I] * 7 + [_P],
        "gla_smem_bytes": [_I] * 4,
        "gla_max_smem": [],
        "gla_tc_smem_bytes": [],
        "gla_tc_blocks_per_sm": [],
        "gla_ssd_smem_bytes": [_I],
        "gla_ssd_blocks_per_sm": [_I],
    },
}
_RESTYPES = {"maxmin_smem_bytes": ctypes.c_longlong,
             "gla_smem_bytes": ctypes.c_longlong}

_libs: dict[str, ctypes.CDLL] = {}
# per source: the library's path, the build's seconds and nvcc's output
# (``ptxas -v``: registers and shared memory per kernel)
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all() -> None:
    """Build and load every source that is not loaded yet, one ``nvcc``
    process per source, all started together."""
    todo = [n for n in _SIGNATURES if n not in _libs]
    if not todo:
        return
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        so = _target(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"lib{name}.{os.getpid()}.tmp.so")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (so, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{logs[name]}")
        os.replace(tmp, so)
    seconds = time.perf_counter() - t0
    for name in todo:
        so = _target(name)
        lib = ctypes.CDLL(str(so))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(fn_name, ctypes.c_int)
        build_info[name] = dict(path=str(so), seconds=seconds,
                                log=logs.get(name, ""))
        _libs[name] = lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every source
    first if needed."""
    if name not in _libs:
        build_all()
    return _libs[name]
