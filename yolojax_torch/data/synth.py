"""Synthetic VOC- and COCO-layout dataset writer — a copy of
``yolojax/data/synth.py`` (numpy draws, cv2 to draw and write the images,
imported where it draws).

Where OpenCV is not installed (a card machine may have none), :class:`Raster`
stands in for it: numpy fills the same shapes from the same draws and the
images are written as binary PPM under the same names, which cv2 and the
port's ``data/dataset.py`` decode by their content.  The annotations are
byte for byte the same; the pixels differ at the shapes' edges, where the
two rasterizers round differently, and by the JPEG codec's loss, which the
lossless PPM does not have.

No real VOC/COCO images ship with the repository, so end-to-end runs and
accuracy gates use generated data: 8 shape classes drawn over noisy
backgrounds, several objects per image with capped-IoU occlusion, in VOC2007's
directory layout (JPEGImages / Annotations / ImageSets/Main) or COCO's
(``annotations/instances_*.json`` + image folders), so the normal cache
builder reads it unchanged.  The same seed writes the same files as the JAX
package's writer.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["CLASSES", "generate_voc", "generate_coco", "make_classes", "Raster", "painter"]

CLASSES = ["square", "circle", "triangle", "ring", "cross",
           "diamond", "hbar", "vbar"]
_BASE_COLOR = {  # RGB base per class, jittered per instance
    "square": (230, 60, 60), "circle": (60, 230, 60), "triangle": (70, 90, 235),
    "ring": (235, 235, 60), "cross": (235, 70, 235), "diamond": (60, 230, 230),
    "hbar": (245, 150, 40), "vbar": (160, 60, 245),
}


class Raster:
    """The part of cv2's API the generator calls, in numpy: filled circles,
    rectangles, ellipses (filled, or a ring of a thickness) and convex
    polygons, and ``imwrite`` of binary PPM.  A pixel is painted where its
    integer coordinates lie inside the shape."""

    @staticmethod
    def _paint(img, y0, y1, x0, x1, inside, color):
        y0, x0 = max(y0, 0), max(x0, 0)
        y1, x1 = min(y1, img.shape[0] - 1), min(x1, img.shape[1] - 1)
        if y1 < y0 or x1 < x0:
            return
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        region = img[y0:y1 + 1, x0:x1 + 1]
        region[inside(yy.astype(np.float64), xx.astype(np.float64))] = color

    def rectangle(self, img, pt1, pt2, color, thickness):
        (xa, ya), (xb, yb) = pt1, pt2
        self._paint(img, min(ya, yb), max(ya, yb), min(xa, xb), max(xa, xb),
                    lambda yy, xx: np.ones(yy.shape, bool), color)

    def circle(self, img, center, radius, color, thickness):
        self.ellipse(img, center, (radius, radius), 0, 0, 360, color, thickness)

    def ellipse(self, img, center, axes, angle, start, end, color, thickness):
        (cx, cy), (a, b) = center, axes
        outer = 0.0 if thickness < 0 else thickness / 2.0
        inner = None if thickness < 0 else (a - thickness / 2.0, b - thickness / 2.0)
        ao, bo = a + outer, b + outer

        def inside(yy, xx):
            keep = ((xx - cx) / max(ao, 0.5)) ** 2 + ((yy - cy) / max(bo, 0.5)) ** 2 <= 1.0
            if inner is not None and min(inner) > 0:
                keep &= ((xx - cx) / inner[0]) ** 2 + ((yy - cy) / inner[1]) ** 2 > 1.0
            return keep

        r = int(np.ceil(max(ao, bo)))
        self._paint(img, cy - r, cy + r, cx - r, cx + r, inside, color)

    def fillPoly(self, img, polys, color):  # noqa: N802 - cv2's name
        for pts in polys:
            pts = np.asarray(pts, np.float64)                      # (N, 2) x, y
            nxt = np.roll(pts, -1, axis=0)
            # a convex polygon: inside where every edge's cross product has one sign
            area = np.sum(pts[:, 0] * nxt[:, 1] - nxt[:, 0] * pts[:, 1])
            sign = 1.0 if area >= 0 else -1.0

            def inside(yy, xx, pts=pts, nxt=nxt, sign=sign):
                keep = np.ones(yy.shape, bool)
                for (xa, ya), (xb, yb) in zip(pts, nxt):
                    keep &= sign * ((xb - xa) * (yy - ya) - (yb - ya) * (xx - xa)) >= 0
                return keep

            self._paint(img, int(pts[:, 1].min()), int(pts[:, 1].max()),
                        int(pts[:, 0].min()), int(pts[:, 0].max()), inside, color)

    @staticmethod
    def imwrite(path, bgr) -> bool:
        h, w = bgr.shape[:2]
        rgb = np.ascontiguousarray(bgr[:, :, ::-1])
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes())
        return True


def painter():
    """cv2 where OpenCV is installed, else :class:`Raster`."""
    try:
        import cv2
    except ImportError:
        return Raster()
    return cv2


def _draw(img, cls: str, y0, x0, hh, ww, color):
    cv2 = painter()

    y1, x1 = y0 + hh, x0 + ww
    if cls in ("square", "hbar", "vbar"):
        cv2.rectangle(img, (x0, y0), (x1 - 1, y1 - 1), color, -1)
    elif cls == "circle":
        cv2.ellipse(img, ((x0 + x1) // 2, (y0 + y1) // 2), (ww // 2, hh // 2),
                    0, 0, 360, color, -1)
    elif cls == "triangle":
        pts = np.array([[(x0 + x1) // 2, y0], [x0, y1 - 1], [x1 - 1, y1 - 1]])
        cv2.fillPoly(img, [pts], color)
    elif cls == "ring":
        t = max(3, min(hh, ww) // 6)
        cv2.ellipse(img, ((x0 + x1) // 2, (y0 + y1) // 2),
                    (ww // 2 - t // 2, hh // 2 - t // 2), 0, 0, 360, color, t)
    elif cls == "cross":
        bw, bh = max(3, ww // 4), max(3, hh // 4)
        cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
        cv2.rectangle(img, (x0, cy - bh // 2), (x1 - 1, cy + bh // 2), color, -1)
        cv2.rectangle(img, (cx - bw // 2, y0), (cx + bw // 2, y1 - 1), color, -1)
    elif cls == "diamond":
        pts = np.array([[(x0 + x1) // 2, y0], [x1 - 1, (y0 + y1) // 2],
                        [(x0 + x1) // 2, y1 - 1], [x0, (y0 + y1) // 2]])
        cv2.fillPoly(img, [pts], color)


def _iou(a, b):
    ymin = max(a[0], b[0]); xmin = max(a[1], b[1])
    ymax = min(a[2], b[2]); xmax = min(a[3], b[3])
    inter = max(ymax - ymin, 0) * max(xmax - xmin, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def make_classes(n: int) -> tuple[list[str], list[tuple]]:
    """``n`` synthetic classes (names + base colors).

    Beyond the 8 canonical shape classes, class ``i`` draws shape ``i % 8``
    in hue slot ``i // 8`` of an evenly split wheel — so an 80-class
    COCO-style dataset (BASELINE config 4) has learnable (shape, hue)
    signatures where same-shape classes are separated by a full 360/ceil(n/8)
    degrees (36° at n=80; the per-instance brightness jitter in _gen_image
    scales RGB, which preserves hue — the class signal survives it).
    """
    import colorsys
    import math

    if n <= len(CLASSES):
        return CLASSES[:n], [_BASE_COLOR[c] for c in CLASSES[:n]]
    slots = math.ceil(n / len(CLASSES))
    names, colors = [], []
    for i in range(n):
        shape = CLASSES[i % len(CLASSES)]
        names.append(f"{shape}_{i}" if i >= len(CLASSES) else shape)
        r, g, b = colorsys.hsv_to_rgb((i // len(CLASSES)) / slots, 0.9, 0.95)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return names, colors


def _gen_image(rng, classes: list[str], colors: list[tuple],
               occlusion_iou_cap: float):
    """One synthetic image.  Returns (img RGB uint8, [(cls_idx, box)], h, w).

    The rng call sequence for the 8 default classes is identical to the
    original generate_voc loop, so VOC gate datasets are unchanged.
    """
    cv2 = painter()

    h = int(rng.integers(330, 560)); w = int(rng.integers(330, 560))
    img = rng.integers(20, 70, (h, w, 3)).astype(np.uint8)  # noisy bg
    # low-contrast distractor blobs that belong to no class
    for _ in range(int(rng.integers(0, 4))):
        yy, xx = int(rng.integers(0, h)), int(rng.integers(0, w))
        cv2.circle(img, (xx, yy), int(rng.integers(5, 18)),
                   tuple(int(v) for v in rng.integers(50, 95, 3)), -1)
    boxes, objs = [], []
    n_obj = int(rng.integers(2, 7))
    for _ in range(n_obj):
        for _try in range(25):
            ci = int(rng.integers(0, len(classes)))
            shape = CLASSES[ci % len(CLASSES)]
            if shape == "hbar":
                hh = int(rng.integers(28, 70)); ww = int(rng.integers(90, 200))
            elif shape == "vbar":
                hh = int(rng.integers(90, 200)); ww = int(rng.integers(28, 70))
            else:
                hh = int(rng.integers(44, 170))
                ww = int(hh * rng.uniform(0.8, 1.25))
            if hh >= h - 2 or ww >= w - 2:
                continue
            y0 = int(rng.integers(1, h - hh)); x0 = int(rng.integers(1, w - ww))
            box = (y0, x0, y0 + hh, x0 + ww)
            # occlusion-heavy: overlap allowed, but cap pairwise IoU so
            # the earlier (occluded) object stays recoverable
            if all(_iou(box, b) < occlusion_iou_cap for b in boxes):
                break
        else:
            continue
        base = np.array(colors[ci], float)
        color = tuple(int(np.clip(v, 0, 255))
                      for v in base * rng.uniform(0.75, 1.15) + rng.normal(0, 10, 3))
        _draw(img, shape, y0, x0, hh, ww, color)
        boxes.append(box)
        objs.append((ci, box))
    return img, objs, h, w


def generate_voc(root: str, n_images: int = 600, seed: int = 7,
                 occlusion_iou_cap: float = 0.45) -> str:
    """Write a VOC2007-layout synthetic dataset under root; returns its path.

    trainval/test split is ~5:1 (at least half the images stay in trainval).
    """
    cv2 = painter()

    voc = os.path.join(root, "VOC2007")
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = []
    n_obj_total = 0
    colors = [_BASE_COLOR[c] for c in CLASSES]
    for i in range(n_images):
        img, objs, h, w = _gen_image(rng, CLASSES, colors, occlusion_iou_cap)
        n_obj_total += len(objs)
        image_id = f"{i:06d}"
        ids.append(image_id)
        cv2.imwrite(os.path.join(voc, "JPEGImages", f"{image_id}.jpg"),
                    img[:, :, ::-1])
        parts = [f"<annotation><size><width>{w}</width><height>{h}</height></size>"]
        for ci, (y0, x0, y1, x1) in objs:
            parts.append(
                f"<object><name>{CLASSES[ci]}</name><difficult>0</difficult>"
                f"<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin>"
                f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")
        parts.append("</annotation>")
        with open(os.path.join(voc, "Annotations", f"{image_id}.xml"), "w") as f:
            f.write("".join(parts))
    n_test = min(max(100, n_images // 6), n_images // 2)
    with open(os.path.join(voc, "ImageSets/Main/trainval.txt"), "w") as f:
        f.write("\n".join(ids[:-n_test]))
    with open(os.path.join(voc, "ImageSets/Main/test.txt"), "w") as f:
        f.write("\n".join(ids[-n_test:]))
    print(f"generated {n_images} images ({n_obj_total} objects, "
          f"{n_images - n_test} train / {n_test} test) in {voc}", flush=True)
    return voc


def generate_coco(root: str, n_images: int = 600, seed: int = 7,
                  occlusion_iou_cap: float = 0.45, num_classes: int = 80,
                  crowd_frac: float = 0.04) -> str:
    """Write a COCO-layout synthetic dataset under ``root``; returns its path.

    Layout matches what data/coco.py parses (SURVEY.md §2.3, BASELINE
    config 4): ``annotations/instances_{train,val}2017.json`` + images under
    ``train2017/`` / ``val2017/``, pixel-xywh bboxes, non-contiguous category
    ids (ids are ``3*i + 1`` to exercise the name-based remap), and
    ``iscrowd=1`` on a ``crowd_frac`` fraction of annotations (mapped to the
    ``difficult``/ignore flag by the parser and the COCO AP protocol).
    """
    import json

    cv2 = painter()

    classes, colors = make_classes(num_classes)
    coco = os.path.join(root, "coco")
    os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
    n_val = min(max(50, n_images // 6), n_images // 2)
    splits = {"train2017": range(n_images - n_val),
              "val2017": range(n_images - n_val, n_images)}
    rng = np.random.default_rng(seed)
    n_obj_total = 0
    for split, idxs in splits.items():
        os.makedirs(os.path.join(coco, split), exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in idxs:
            img, objs, h, w = _gen_image(rng, classes, colors, occlusion_iou_cap)
            file_name = f"{i:012d}.jpg"
            cv2.imwrite(os.path.join(coco, split, file_name), img[:, :, ::-1])
            images.append({"id": i, "file_name": file_name,
                           "width": w, "height": h})
            for ci, (y0, x0, y1, x1) in objs:
                crowd = int(rng.uniform() < crowd_frac)
                annotations.append({
                    "id": ann_id, "image_id": i, "category_id": 3 * ci + 1,
                    "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                    "area": float((x1 - x0) * (y1 - y0)),
                    "iscrowd": crowd,
                })
                ann_id += 1
            n_obj_total += len(objs)
        db = {
            "info": {"description": "yolojax synthetic COCO"},
            "images": images,
            "annotations": annotations,
            "categories": [{"id": 3 * ci + 1, "name": name,
                            "supercategory": "shape"}
                           for ci, name in enumerate(classes)],
        }
        with open(os.path.join(coco, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump(db, f)
    print(f"generated {n_images} images ({n_obj_total} objects, "
          f"{n_images - n_val} train / {n_val} val, {num_classes} classes) "
          f"in {coco}", flush=True)
    return coco
