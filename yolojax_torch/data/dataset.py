"""Host-side dataset — a copy of ``yolojax/data/dataset.py``: decode, paste
into a fixed-size gray canvas, and pad the labels.

* canvas: (C, C, 3) uint8, image centered, gray(127) around it; an image
  larger than the canvas is downscaled on the host (the boxes are
  normalized, so they stay);
* labels: padded to ``max_boxes`` rows with a validity mask.

``decoded_dir`` turns on the decoded-canvas cache: every canvas is decoded
once into a uint8 memmap and later epochs are copies.  cv2 is imported only
where an image is decoded or downscaled; a caller without cv2 passes its own
``imread``.  A binary PPM (P6, maxval 255: what ``data/synth.py`` writes
where OpenCV is missing) is decoded by numpy, by its content whatever its
name, to the pixels cv2 gives.
"""

from __future__ import annotations

import os
import re

import numpy as np

__all__ = ["Dataset", "collate", "GRAY"]

GRAY = 127


_PPM_HEADER = re.compile(rb"P6\s+(\d+)\s+(\d+)\s+255\s")


def _read_ppm(path: str) -> np.ndarray | None:
    """A binary PPM's pixels (H, W, 3) RGB, or None for any other file."""
    with open(path, "rb") as f:
        if f.read(2) != b"P6":
            return None
        data = b"P6" + f.read()
    header = _PPM_HEADER.match(data)
    if header is None:
        return None
    w, h = int(header.group(1)), int(header.group(2))
    return np.frombuffer(data, np.uint8, h * w * 3, header.end()).reshape(h, w, 3)


def _imread_rgb(path: str) -> np.ndarray:
    img = _read_ppm(path)
    if img is not None:
        return img
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot decode image {path}")
    return img[:, :, ::-1]  # BGR → RGB


class Dataset:
    """Record store over one phase's cached records."""

    def __init__(self, records: list[dict], canvas: int = 672, max_boxes: int = 60,
                 imread=_imread_rgb, decoded_dir: str | None = None):
        self.records = records
        self.canvas = canvas
        self.max_boxes = max_boxes
        self.imread = imread
        self._mm = None
        self._mm_hw = None
        if decoded_dir is not None:
            self._attach_decoded_cache(decoded_dir)

    def __len__(self) -> int:
        return len(self.records)

    def _attach_decoded_cache(self, decoded_dir: str) -> None:
        os.makedirs(decoded_dir, exist_ok=True)
        n, c = len(self.records), self.canvas
        mm_path = os.path.join(decoded_dir, f"canvases_{n}x{c}.u8")
        hw_path = os.path.join(decoded_dir, f"hw_{n}x{c}.npy")
        if not (os.path.exists(mm_path) and os.path.exists(hw_path)):
            mm = np.memmap(mm_path + ".tmp", np.uint8, "w+", shape=(n, c, c, 3))
            hw = np.zeros((n, 2), np.float32)
            for i in range(n):
                canvas, size = self._decode(i)
                mm[i] = canvas
                hw[i] = size
            mm.flush()
            del mm
            np.save(hw_path, hw)
            os.replace(mm_path + ".tmp", mm_path)
        self._mm = np.memmap(mm_path, np.uint8, "r", shape=(n, c, c, 3))
        self._mm_hw = np.load(hw_path)

    def _decode(self, idx: int):
        rec = self.records[idx]
        img = self.imread(rec["path"])
        h, w = img.shape[:2]
        c = self.canvas
        if max(h, w) > c:  # downscale oversized images on host
            import cv2

            s = c / max(h, w)
            img = cv2.resize(img, (max(1, int(w * s)), max(1, int(h * s))),
                             interpolation=cv2.INTER_AREA)
            h, w = img.shape[:2]
        canvas = np.full((c, c, 3), GRAY, np.uint8)
        oy, ox = (c - h) // 2, (c - w) // 2
        canvas[oy:oy + h, ox:ox + w] = img
        return canvas, np.asarray([h, w], np.float32)

    def load(self, idx: int) -> dict:
        rec = self.records[idx]
        if self._mm is not None:
            canvas = np.asarray(self._mm[idx])
            h, w = self._mm_hw[idx]
        else:
            canvas, (h, w) = self._decode(idx)

        g = self.max_boxes
        n = min(len(rec["cls"]), g)
        yx_min = np.zeros((g, 2), np.float32)
        yx_max = np.zeros((g, 2), np.float32)
        cls = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        difficult = np.zeros((g,), bool)
        yx_min[:n] = rec["yx_min"][:n]
        yx_max[:n] = rec["yx_max"][:n]
        cls[:n] = rec["cls"][:n]
        valid[:n] = True
        difficult[:n] = rec["difficult"][:n]
        return {
            "canvas": canvas,
            "hw": np.asarray([h, w], np.float32),
            "yx_min": yx_min,
            "yx_max": yx_max,
            "cls": cls,
            "valid": valid,
            "difficult": difficult,
            "index": np.asarray(idx, np.int32),
        }


def collate(items: list[dict]) -> dict:
    """Stack per-item dicts into batch arrays (rectangular by construction)."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
