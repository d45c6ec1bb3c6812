"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` becomes `build/torch_kernels/<name>-<hash>.so`,
where the hash covers the source, the headers beside it and the flags,
so a stale library is never loaded. A variant (`VARIANTS`) is another
library built from a source with flags of its own: the ablation library
`conformer_block_ablate` is `conformer_block.cu` with `-DEET_ABLATE`,
which adds an entry and leaves the production library as it is. The build runs at first use (or all
sources at once, in parallel, through `build_all`). libcuda is not
linked: the one call of it the kernels need, the tensor-map encoder, is
looked up with `dlsym` at first use (`-ldl`). Every C entry takes
plain pointers (`c_void_p`), ints and the CUDA stream, and returns a
`cudaError_t`; `check` turns a nonzero one into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl"]

# library name -> (source stem, extra nvcc flags)
VARIANTS = {"conformer_block_ablate": ("conformer_block", ["-DEET_ABLATE"])}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str):
    """(the .cu path, the nvcc flags) of a library."""
    stem, extra = VARIANTS.get(name, (name, []))
    return os.path.join(CSRC, stem + ".cu"), FLAGS + extra


def _digest(name: str) -> str:
    src, flags = _source(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(out + ".log", "w")
    src, flags = _source(name)
    cmd = [nvcc(), *flags, "-o", tmp, src]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(out + ".log") as f:
            raise RuntimeError(f"nvcc failed for {name} (rc={rc}):\n{f.read()}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> None:
    """Build every named source at once, one nvcc process each."""
    names = list(names)
    jobs = [_start(n) for n in names]
    errors = []
    for n, j in zip(names, jobs):   # wait for every job, then report
        try:
            _finish(n, j)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(lib_path(name))
            lib.eet_error_string.restype = ctypes.c_char_p
            lib.eet_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.eet_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
