"""Fused decode + per-class greedy NMS: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/nms.py::postprocess_fused_pallas``.  The kernel
(``csrc/postprocess_fused.cu``) is CUDA C++ for ``sm_90a``, compiled with
``nvcc`` at first use into ``build/yolojax_torch/`` under the hash of its
source and flags, and loaded with ``ctypes``.  The plain version is
``ops.postprocess.postprocess_raw`` (decode → batched greedy NMS).

:func:`postprocess_fused` runs the plain version only for a raw head that
lies on the CPU.  For a CUDA tensor it launches the kernel or raises: a
failed build, load or launch is an error, never a fallback.
``postprocess_fused.launches`` counts the kernel's launches.
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

from ..ops.postprocess import PostProcessed, postprocess_raw

__all__ = ["postprocess_fused", "build", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "postprocess_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yolojax_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# static shared memory a block gets without opting in
_SMEM_LIMIT = 48 * 1024


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc") or (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           f"{SOURCE.name}")
    return path


def build() -> Path:
    """Compile the kernel library if no build for this source + flags exists;
    returns its path.  The compiler's report (``-Xptxas=-v``) is kept beside
    it as ``.log``."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"postprocess_fused-{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.yolo_postprocess_fused.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                           i32, i32, i32, i32, i32, f32, f32, i32, ptr]
    lib.yolo_postprocess_fused.restype = i32
    lib.yolo_cuda_error_string.argtypes = [i32]
    lib.yolo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def postprocess_fused(raw: torch.Tensor, anchors, threshold: float, overlap: float,
                      topk: int) -> PostProcessed:
    """raw (B, H, W, A*(5+C)) + anchors (A, 2) → PostProcessed, decode and
    per-class greedy NMS in one kernel (plain version for a CPU tensor)."""
    if raw.device.type == "cpu":
        return postprocess_raw(raw, anchors, threshold, overlap, topk)
    if raw.device.type != "cuda":
        raise ValueError(f"postprocess_fused: unsupported device {raw.device}")
    b, h, w, ch = raw.shape
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=raw.device).contiguous()
    a = anchors.shape[0]
    if anchors.shape != (a, 2) or ch % a or ch // a < 6:
        raise ValueError(f"postprocess_fused: head {tuple(raw.shape)} does not match "
                         f"anchors {tuple(anchors.shape)}")
    c, n = ch // a - 5, h * w * a
    smem = (5 * n + 2 * topk) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"postprocess_fused: {n} candidates and topk {topk} need {smem} B "
                         f"of shared memory per block, over {_SMEM_LIMIT}")
    if b > 65535:
        raise ValueError(f"postprocess_fused: batch {b} over the grid's 65535")
    raw32 = raw.to(torch.float32).contiguous()
    dev = raw.device
    yx_min = torch.empty((b, c, topk, 2), dtype=torch.float32, device=dev)
    yx_max = torch.empty((b, c, topk, 2), dtype=torch.float32, device=dev)
    conf = torch.empty((b, c, topk), dtype=torch.float32, device=dev)
    count = torch.empty((b, c), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yolo_postprocess_fused(
            raw32.data_ptr(), anchors.data_ptr(), yx_min.data_ptr(), yx_max.data_ptr(),
            conf.data_ptr(), count.data_ptr(), b, h, w, a, c, threshold, overlap, topk, stream)
    if err:
        raise RuntimeError("postprocess_fused launch failed: "
                           f"{lib.yolo_cuda_error_string(err).decode()} ({err})")
    postprocess_fused.launches += 1
    keep = torch.arange(topk, device=dev) < count[..., None]
    return PostProcessed(yx_min, yx_max, conf, keep)


postprocess_fused.launches = 0
