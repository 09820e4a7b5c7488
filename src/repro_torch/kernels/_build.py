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

import numpy as np
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
    """Call a C entry point on the current card; raise if it reports a CUDA error."""
    rc = function(name, argtypes)(*args)
    if rc != 0:
        msg = library().svc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def launch_on(index: int, name: str, argtypes: tuple, *args) -> None:
    """``launch`` on card ``index``, the card that holds the wrapper's
    tensors, with that card's current stream appended as the entry point's
    last argument.  The current card is switched only when it is another,
    and switched back after; the first launch on each card checks that the
    library's runtime sees the card PyTorch made current."""
    if torch._C._cuda_getDevice() == index and index in _runtime_checked:
        launch(name, argtypes, *args, torch._C._cuda_getCurrentRawStream(index))
        return
    call_on(index, name, argtypes, *args, torch._C._cuda_getCurrentRawStream(index))


def call_on(index: int, name: str, argtypes: tuple, *args) -> None:
    """``launch`` with card ``index`` current: switched only when it is
    another, and switched back after; the first call on each card checks
    that the library's runtime sees the card PyTorch made current."""
    prev = torch._C._cuda_getDevice()
    if prev != index:
        torch._C._cuda_setDevice(index)
    try:
        if index not in _runtime_checked:
            _check_runtime_device(index)
        launch(name, argtypes, *args)
    finally:
        if prev != index:
            torch._C._cuda_maybeExchangeDevice(prev)


def wait(index: int) -> None:
    """The host waits for every launch queued so far on card ``index``'s
    current stream (``svc_stream_wait``): the one host read of a wrapper
    whose result lies in mapped host memory.  ``wait.calls`` counts them."""
    launch_on(index, "svc_stream_wait", (P,))
    wait.calls += 1


wait.calls = 0


class Mapped:
    """Page-locked host memory mapped into every card's address space
    (``svc_host_alloc`` in ``csrc/common.cu``: mapped and portable).
    ``device`` is the address a kernel dereferences, ``host`` the same
    bytes as a numpy uint8 array."""

    __slots__ = ("nbytes", "host_ptr", "device", "host")

    def __init__(self, nbytes: int, host_ptr: int, device: int):
        self.nbytes, self.host_ptr, self.device = nbytes, host_ptr, device
        self.host = np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(host_ptr))


_mapped: Dict[object, Mapped] = {}


def mapped(key, nbytes: int, index: int) -> Mapped:
    """The mapped buffer ``key`` (a wrapper's own name for it), at least
    ``nbytes`` long: made on first use with card ``index`` current, and
    made anew at the next power of two when a call needs more (the old one
    freed first).  A wrapper owns its buffers between its first write and
    its wait, and every call waits before it returns, so a call never
    finds a kernel still reading them; the next call writes them over.
    Read ``host`` after each call of this function: a regrown buffer has
    a new one."""
    buf = _mapped.get(key)
    if buf is not None and buf.nbytes >= nbytes:
        return buf
    size = 4096
    while size < nbytes:
        size *= 2
    if buf is not None:
        del _mapped[key]
        call_on(index, "svc_host_free", (P,), buf.host_ptr)
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    call_on(index, "svc_host_alloc", (I64, ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.POINTER(ctypes.c_void_p)),
            size, ctypes.byref(host), ctypes.byref(dev))
    buf = _mapped[key] = Mapped(size, host.value, dev.value)
    return buf


_runtime_checked: set = set()


def _check_runtime_device(index: int) -> None:
    """The library links its own (static) CUDA runtime; its kernels launch
    on the CUDA context current in this thread, which PyTorch's runtime
    sets.  Raise if the library's ``cudaGetDevice`` disagrees with
    PyTorch's card."""
    lib = library()
    lib.svc_current_device.restype = ctypes.c_int
    seen = lib.svc_current_device()
    if seen != index:
        raise RuntimeError(f"the kernel library's runtime is on device {seen}, "
                           f"PyTorch's current device is {index}")
    _runtime_checked.add(index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index`` (a persistent grid's bound)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_visible = 0  # CUDA devices this process sees, read on the first check


def cards() -> int:
    """CUDA devices visible to this process (read once)."""
    global _visible
    if not _visible:
        _visible = torch.cuda.device_count()
    return _visible


def index(device) -> int:
    """The card index of ``device`` (a ``torch.device``, a string or an
    int): ``torch.device("cuda")``, without an index, is the current card."""
    if type(device) is int:
        return device
    if type(device) is not torch.device:
        device = torch.device(device)
    i = device.index
    return torch._C._cuda_getDevice() if i is None else i


def cuda_device(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` → ``cuda:<current>``),
    the form that keys the wrappers' per-card caches."""
    if type(device) is not torch.device:
        device = torch.device(device)
    if device.index is None and device.type == "cuda":
        return torch.device("cuda", torch._C._cuda_getDevice())
    return device


def stream(device=None) -> int:
    """The current stream of ``device``'s card (the current card without
    one) as a raw handle: the value of ``torch.cuda.current_stream(device)
    .cuda_stream`` without building a Stream object, which costs more host
    time than a launch's ctypes call (``tools/kernel_profile.py --only
    hash_threshold`` times both)."""
    if type(device) is not int:
        device = torch._C._cuda_getDevice() if device is None else index(device)
    return torch._C._cuda_getCurrentRawStream(device)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda(device) -> int:
    """Raise unless ``device`` is a CUDA device that this process sees;
    return its card index (the current card for ``cuda`` without one)."""
    if type(device) is not torch.device:
        device = torch.device(device)
    i = device.index
    if i is not None and i < _visible and device.type == "cuda":
        return i  # a card seen before: what every wrapper call takes
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    if i is None:
        i = torch._C._cuda_getDevice()
    n = cards()
    if not 0 <= i < n:
        seen = f"{n} (cuda:0 to cuda:{n - 1})" if n else "none"
        raise ValueError(f"{device} is not a visible CUDA device: this process sees {seen}")
    return i


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
