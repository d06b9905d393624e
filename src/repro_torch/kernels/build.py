"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout. The hash covers the source and the flags, so an edited source
is rebuilt at its next use and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them together.

``-fmad=false`` keeps every multiply and add a separate rounding: the
scheduling kernels' decisions are compared bit for bit with their plain
PyTorch versions. The model kernels (attention, SSD scan) are held to a
tolerance and fuse their products with explicit ``fmaf``, which the flag
leaves alone.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("map_fused", "phase1_map", "balance_scan", "flash_attention",
           "decode_attention", "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def lib_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current hash."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict:
    """Compile every library of ``names`` that is missing, in parallel.

    Returns ``{name: {"seconds": s, "cached": bool, "log": str}}``; with
    ``verbose`` the log holds ``ptxas``'s register and shared-memory
    report. Raises RuntimeError naming the source and nvcc's output when
    a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = lib_path(name)
        if target.exists() and not verbose:
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, target)
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    if name not in _LIBS:
        build((name,))
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
