"""Build the CUDA kernels of ``csrc/`` into one shared library; bind with ctypes.

Every ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers),
so each compiles in seconds.  The sources compile in parallel, one ``nvcc``
process per file, for ``sm_90a`` (Hopper), and link into one library whose
directory is keyed by a hash of the sources and flags: the first call in a
fresh checkout builds, later calls load.  Nothing builds at import time —
only the first launch on a CUDA tensor calls ``library()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libsvc_kernels.so"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# what the last build in this process did: seconds, ptxas report, directory
last_build: Dict[str, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return path


def _sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def build() -> Path:
    """Compile every source in parallel and link the library (idempotent)."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = []
        failed = []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            report.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(report))
        tmp_so = Path(tmp) / LIB_NAME
        link = [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp_so),
                *[str(o) for _s, o, _p in procs]]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        (so.parent / "ptxas.txt").write_text("\n".join(report))
        os.replace(tmp_so, so)  # atomic: concurrent builders never see half a file
    last_build.update(seconds=time.perf_counter() - t0, path=str(so),
                      ptxas=(so.parent / "ptxas.txt").read_text())
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.svc_error_string.argtypes = [ctypes.c_int]
    lib.svc_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def function(name: str, argtypes: tuple):
    """A C entry point of the library with its argument types declared."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error."""
    rc = function(name, argtypes)(*args)
    if rc != 0:
        msg = library().svc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda(device: torch.device) -> None:
    """The kernels launch on the library's current device: card 0."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    if device.index not in (None, 0):
        raise ValueError(f"kernels launch on cuda:0 only, got {device}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
          shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
F32 = ctypes.c_float
