"""Host C++ greedy NMS over ``ctypes`` — counterpart of
``yolojax/native/__init__.py``.

The host detect path (``Inference.detect_fn_host``, BASELINE config 1:
"CPU forward + NMS") runs its per-(image, class) greedy NMS in ``nms.cpp``,
a copy of the JAX package's, with the problems spread over OpenMP threads.
It is host code, not a card kernel: no TPU kernel stands behind it.  It
picks what ``ops/nms.py::nms_select`` and the fused kernel pick, ties and
IoUs on the threshold included, where the reference's library does not
(``nms.cpp``'s header says how).

The library is compiled with ``g++ -O3 -march=native -fopenmp -shared -fPIC
-ffp-contract=off`` at first use into the git-ignored
``build/yolojax_torch/``, named by a hash of the source and the flags.  :func:`build` raises with the
compiler's message; :func:`native_nms_available` says whether the library
loads (the detect CLI takes the host path only then); :func:`nms_native_batch`
raises when it does not, as the reference's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR

__all__ = ["SOURCE", "GXX_FLAGS", "library_path", "build", "native_nms_available", "nms_native",
           "nms_native_batch"]

_LOG = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "nms.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-ffp-contract=off")
_FP, _IP = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
_lib = None
_error = None     # why the library did not load, once tried


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"nms-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``nms.cpp`` if no build of this source and these flags exists;
    returns the library's path, or raises with g++'s message."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, check=False)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ {' '.join(GXX_FLAGS)} failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    _LOG.info("built native NMS: %s", lib)
    return lib


def _load():
    global _lib, _error
    if _lib is None and _error is None:
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:   # no compiler, or a library that will not load
            _error = str(e)
            _LOG.info("native NMS unavailable: %s", e)
            return None
        lib.nms_batch.restype = None
        lib.nms_batch.argtypes = [_FP, _FP, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_int32, _IP, _FP, _IP]
        _lib = lib
    return _lib


def native_nms_available() -> bool:
    return _load() is not None


def nms_native_batch(boxes: np.ndarray, scores: np.ndarray, threshold: float,
                     overlap: float, max_out: int):
    """Batched exact greedy NMS on the host.

    boxes (G, N, 4) [ymin, xmin, ymax, xmax] f32, scores (G, N) f32 →
    (idx (G, max_out) i32, conf (G, max_out) f32, count (G,) i32): the picks
    of ``ops.nms.nms_select``, the problems parallel over OpenMP."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native NMS library unavailable: {_error}")
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    g, n = scores.shape
    if boxes.shape != (g, n, 4):
        raise ValueError(f"nms_native_batch: boxes {boxes.shape}, scores {scores.shape}; "
                         "expected (G, N, 4) and (G, N)")
    idx = np.zeros((g, max_out), np.int32)
    conf = np.zeros((g, max_out), np.float32)
    count = np.zeros((g,), np.int32)
    lib.nms_batch(boxes.ctypes.data_as(_FP), scores.ctypes.data_as(_FP), g, n, threshold,
                  overlap, max_out, idx.ctypes.data_as(_IP), conf.ctypes.data_as(_FP),
                  count.ctypes.data_as(_IP))
    return idx, conf, count


def nms_native(yx_min: np.ndarray, yx_max: np.ndarray, scores: np.ndarray,
               threshold: float, overlap: float, max_out: int):
    """One problem, with ``ops.nms.nms_select``'s return contract: (idx,
    conf, valid), each (max_out,)."""
    boxes = np.concatenate([yx_min, yx_max], axis=-1)[None]
    idx, conf, count = nms_native_batch(boxes, scores[None], threshold, overlap, max_out)
    return idx[0], conf[0], np.arange(max_out) < count[0]
