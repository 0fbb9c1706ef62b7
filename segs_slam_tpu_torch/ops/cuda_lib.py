"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into a shared library that is loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries are built on first use into
`build/segs_slam_tpu_torch/` at the root of the checkout, named by a hash of
the source, the shared headers (`csrc/*.cuh`) and the flags so that a stale
build is never loaded. `launch` calls an entry point on the current stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "segs_slam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, csrc: Path = CSRC) -> Path:
    """Compile <csrc>/<name>.cu (if not already built) and return the .so
    path; csrc defaults to the package's sources (another checkout's, to
    time an earlier kernel beside this one). The compiler's output,
    including ptxas register and shared-memory usage, is kept beside it as
    <lib>.log."""
    src = Path(csrc) / f"{name}.cu"
    headers = b"".join(h.read_bytes()
                       for h in sorted(Path(csrc).glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = ctypes.CDLL(str(build_library(name)))
    lib.segs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.segs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.segs_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def launch(library: str, entry: str, argtypes: list, device: torch.device,
           args: tuple) -> None:
    """Call the C entry point `entry` of csrc/<library>.cu with `args` and
    the device's current stream (the last of `argtypes`, set with an int
    result at the first call); raise on the CUDA error code it returns."""
    lib = load_library(library)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    check(lib, code, f"{entry} launch")
