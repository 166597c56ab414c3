"""Build and load the hand-written CUDA kernels in `repro_torch/csrc/`.

The route is nvcc into one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/<hash>/librepro_kernels.so csrc/*.cu

Each source compiles to an object in its own nvcc process, all started
together, then one nvcc links them. `--use_fast_math` is never passed: the
codec relies on IEEE division. The library is built at first use, keyed
by a hash of the sources and flags, under `build/repro_torch/` at the
root of the checkout, and written through a temporary name so a process
building it concurrently never loads a half-written file. Nothing here
runs at import.

`Kernel` binds one exported C function. Calling it launches on PyTorch's
current stream, raises if `cudaGetLastError()` was not 0, and adds one to
its `launches` count -- the only place a count moves.

`LIB` is the ``repro_torch`` operator namespace: each kernel module
defines its op there with a CUDA implementation (the launcher), a CPU one
(the plain version) and a fake one (shapes and types only, for traced
steps). `torch.library.Library` rather than `torch.library.custom_op`:
the latter wraps every call in a Python autograd layer, which the serving
runtime's host-bound requests pay for (`PERF.md`, section 6).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None

LIB = torch.library.Library("repro_torch", "FRAGMENT")


def define_op(schema: str, cuda, cpu, fake) -> None:
    """Define ``repro_torch::<schema>`` with its CUDA, CPU and fake
    implementations."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA kernels cannot be built")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, cwd: Path, log: Path) -> None:
    """Start every command at once, wait for all, keep their output."""
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with open(log, "a") as f:
        for cmd, out in zip(cmds, outs):
            f.write("$ " + " ".join(cmd) + "\n" + out + "\n")
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        cus = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (cu.stem + ".o") for cu in cus]
        log = tmp / "build.log"
        _run_all([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(cu), "-o", str(o)]
                  for cu, o in zip(cus, objs)], tmp, log)
        part = tmp / LIB_NAME
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(part), *map(str, objs)]], tmp, log)
        os.replace(log, out_dir / "build.log")
        os.replace(part, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def build_log() -> str:
    """nvcc's output (ptxas register and spill counts) for the current sources."""
    path = BUILD_ROOT / _digest() / "build.log"
    return path.read_text() if path.exists() else ""


class Kernel:
    """One exported C launcher: `repro_<name>(..., stream) -> cudaError_t`.

    `argtypes` lists the arguments before the stream (ctypes.c_void_p for
    every pointer, so 64-bit addresses are never cut to a C int).
    """

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.symbol = "repro_" + name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of one of `dtypes`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
