"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first use
with ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (listed
in .gitignore), keyed by a hash of the source and the flags, and loaded with
``ctypes``. ``build_all`` compiles every source at once, one ``nvcc``
process each.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream and returns ``cudaGetLastError()``;
``check`` raises on a non-zero code. ``LAUNCHES`` counts kernel launches per
wrapper (incremented only where a wrapper launches its kernel) so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# like its plain PyTorch twin (torch runs separate multiply and add ops).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]
SOURCES = ("dda", "texfetch", "resample", "probe", "shade", "draws", "hit")

# B1's passes: "traverse" counts its march launches (one per dispatch),
# "traverse_shadow" those of them in shadow mode, "traverse_compact" the
# alive-list launches and "traverse_nee" the dense NEE shadow-ray launches.
# B3's entries: "bilinear_fetch" (texel coordinates given),
# "bilinear_fetch_dirs" (one map at directions) and "bilinear_fetch_dirs2"
# (both maps at jittered directions). "shade" counts the shade kernel's
# launches (one a depth), "draws" kernel D's (one a depth, and one for
# ReSTIR's WRS draw), "hit_prepare" and "hit_merge" kernel H's (each once
# a closest-hit dispatch).
LAUNCHES = {"traverse": 0, "traverse_shadow": 0, "traverse_compact": 0,
            "traverse_nee": 0, "point_fetch": 0, "bilinear_fetch": 0,
            "bilinear_fetch_dirs": 0, "bilinear_fetch_dirs2": 0,
            "temporal_taps": 0, "probe": 0, "shade": 0, "draws": 0,
            "hit_prepare": 0, "hit_merge": 0}

_libs: dict = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> str:
    """The library's path, keyed by its source, the headers beside it (any
    source may include them) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> tuple[float, str]:
    """Compile every kernel source in parallel; returns (seconds, log)."""
    t0 = time.perf_counter()
    jobs = [j for j in (_start_build(n) for n in SOURCES) if j is not None]
    logs = [_finish_build(j) for j in jobs]
    return time.perf_counter() - t0, "\n".join(logs)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        job = _start_build(name)
        if job is not None:
            _finish_build(job)
        _libs[name] = ctypes.CDLL(_lib_path(name))
    return _libs[name]


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, device, shape=None):
    """Validate a kernel argument: device, dtype, contiguity, shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
