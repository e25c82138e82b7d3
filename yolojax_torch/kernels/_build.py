"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface.  It is
compiled for ``sm_90a`` into ``build/yolojax_torch/<name>-<hash>.so``, where
the hash covers the source, every ``*.cuh`` header beside it and the flags,
so an edited source or shared header builds anew.
No fast-math and ``--fmad=false``: the compiler contracts no multiply and add
into one rounding that the source did not ask for.  ``-Xptxas=-v``'s report
(registers, spills) is kept beside the library as ``.log``.

Every library exports ``yolo_cuda_error_string(int)``; each launch entry
point returns ``cudaGetLastError()``, which :class:`Kernel` turns into an
error.

:class:`Kernel` is the launch path all wrappers share.  It loads its library
and binds the entry point's ``argtypes`` once, then per call: enters the
device context only when the tensor's device is not the current one, takes
the current stream's raw handle (no ``torch.cuda.Stream`` object), calls the
entry point and raises on its error code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "build_all", "load",
           "Kernel"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yolojax_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the "
                           "kernels in yolojax_torch/csrc")
    return path


def library_path(source: Path) -> Path:
    """Where the build of ``source`` lives: named by a hash of the source, the
    headers beside it (which it may include) and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` if no build for this source, its headers and the
    flags exists; returns the library's path."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_all(sources) -> list[Path]:
    """Build several sources at once, one ``nvcc`` each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library once per process;
    ``signatures`` maps each entry point to its ``argtypes``, all of which
    return an ``int`` error code."""
    if source not in _loaded:
        lib = ctypes.CDLL(str(build(source)))
        lib.yolo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.yolo_cuda_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    lib = _loaded[source]
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


class Kernel:
    """One launch entry point of ``source``'s library: ``argtypes`` are its
    arguments before the trailing stream.  ``kernel(x, *args)`` launches it
    on the current stream of CUDA tensor ``x``'s device."""

    __slots__ = ("source", "name", "argtypes", "_fn", "_lib")

    def __init__(self, source: Path, name: str, argtypes):
        self.source, self.name, self.argtypes = source, name, list(argtypes)
        self._fn = self._lib = None

    def _bind(self):
        global _current_device, _raw_stream
        if _current_device is None:
            torch.cuda.init()
            _current_device = torch._C._cuda_getDevice
            _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
                lambda index: torch.cuda.current_stream(index).cuda_stream)
        self._lib = load(self.source, {self.name: [*self.argtypes, ctypes.c_void_p]})
        self._fn = getattr(self._lib, self.name)
        return self._fn

    def __call__(self, x: torch.Tensor, *args) -> None:
        index = x.get_device()
        if index < 0:
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        fn = self._fn or self._bind()
        if index == _current_device():
            err = fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{self._lib.yolo_cuda_error_string(err).decode()} ({err})")


# torch's current-device and raw-stream lookups, bound at the first launch
_current_device = _raw_stream = None
