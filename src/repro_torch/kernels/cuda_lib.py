"""Build and load the port's CUDA kernels.

All of ``repro_torch/csrc/*.cu`` is compiled by one ``nvcc`` call for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, into ``build/repro_torch/`` at
the root of the checkout; the library's name carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: dtype codes of csrc/common.cuh
DTYPES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "repro_reduce_sum": [_P, _P, _P, _I64, _I64, _I, _I, _P],
    "repro_scan_inclusive": [_P, _P, _P, _P, _I64, _I64, _I, _I, _P],
    "repro_histogram": [_P, _P, _I64, _I64, _I, _I, _P],
    "repro_gemv": [_P, _P, _P, _I64, _I, _I, _P],
}


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def library_path() -> pathlib.Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"librepro_torch_{h.hexdigest()[:12]}.so"


def build() -> tuple[pathlib.Path, str]:
    """Compile the library unless this exact build exists.  Returns its
    path and the compiler's output ("" when it was already built)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builders never see half
    return path, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``name`` with ``args`` and the current stream of ``device``;
    raise when the launch reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.repro_error_string(err).decode()}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
