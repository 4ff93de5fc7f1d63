"""Build and load the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``; the compilers of all sources that need building run at once.
The build happens at first use, into ``build/repro_torch/`` at the root of
the checkout; a library's name carries a hash of its source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged
one is not.  Nothing here runs at import time: the CPU tests import every
module.
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

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
#: C entry point -> (source stem under csrc/, argument types, the stream last)
_SIGNATURES = {
    "repro_reduce_sum": ("reduce", [_P, _P, _P, _I64, _I64, _I64, _I, _P]),
    "repro_scan_inclusive": ("scan", [_P, _P, _P, _I64, _I64, _I64, _I, _I, _P]),
    "repro_histogram": ("histogram", [_P, _P, _I64, _I64, _I, _I, _P]),
    "repro_gemv": ("gemv", [_P, _P, _P, _I64, _I, _I, _P]),
    "repro_spmv_ell": ("spmv", [_P, _P, _P, _P, _I64, _I, _I, _I, _P]),
    "repro_flash_attention": ("flash_attention",
                              [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _P]),
    "repro_moe_gmm": ("moe_gmm", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "repro_ssd_scan": ("ssd_scan", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def library_path(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build() -> tuple[list[pathlib.Path], str]:
    """Compile every library whose exact build does not exist, all
    compilers at once.  Returns the libraries' paths and the compilers'
    output ("" when nothing was built)."""
    sources = sorted(CSRC.glob("*.cu"))
    paths = [library_path(s) for s in sources]
    todo = [(s, p) for s, p in zip(sources, paths) if not p.exists()]
    if not todo:
        return paths, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, path in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((src, path, tmp, proc))
    log, failed = [], []
    for src, path, tmp, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, path)   # atomic: no concurrent build sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths, "".join(log)


@functools.cache
def library() -> dict[str, ctypes.CDLL]:
    """Source stem -> its loaded library, with the entry points typed."""
    paths, _ = build()
    libs = {src.stem: ctypes.CDLL(str(p))
            for src, p in zip(sorted(CSRC.glob("*.cu")), paths)}
    for name, (stem, args) in _SIGNATURES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    for lib in libs.values():
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return libs


def launch(name: str, device: torch.device, *args) -> None:
    """Call ``name`` with ``args`` and the current stream of ``device``,
    with ``device`` made the current device for the call when it is not;
    raise when the launch reports a CUDA error."""
    lib = library()[_SIGNATURES[name][0]]
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = getattr(lib, name)(*args, stream)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.repro_error_string(err).decode()}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous CUDA tensors on one device, and no input
    that autograd would differentiate: a kernel writes its output through
    raw pointers, so the output has no ``grad_fn`` and the gradient would
    be silently missing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward"
            f" (the reference has none for its Pallas kernels either, and "
            f"trains with use_kernel=False); call it under torch.no_grad() "
            f"or train with use_kernel=False")
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied when its data does not start on 16 bytes:
    the TMA reads from 16-byte aligned bases only."""
    return t.clone() if t.data_ptr() % 16 else t
