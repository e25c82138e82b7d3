"""Box drawing for the detect CLI (counterpart of
``yolojax/utils/visualize.py``): per-class colors, class/conf labels.  Pure
numpy and PIL, so it works headless.
"""

from __future__ import annotations

import colorsys

import numpy as np

__all__ = ["class_colors", "draw_boxes"]


def class_colors(n: int) -> list[tuple[int, int, int]]:
    """n visually distinct colors (golden-ratio hue walk)."""
    colors = []
    h = 0.0
    for _ in range(n):
        r, g, b = colorsys.hsv_to_rgb(h % 1.0, 0.85, 1.0)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
        h += 0.61803398875
    return colors


def draw_boxes(image: np.ndarray, yx_min, yx_max, cls, conf=None,
               category: list[str] | None = None) -> np.ndarray:
    """Draw normalized yx boxes onto an HWC uint8 (or [0, 1] float) image."""
    from PIL import Image, ImageDraw

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    h, w = img.shape[:2]
    cls = np.atleast_1d(cls)
    num_classes = max(int(np.max(cls)) + 1, len(category or [])) if len(cls) else 1
    colors = class_colors(max(num_classes, 1))
    for i in range(len(cls)):
        c = int(cls[i])
        y0, x0 = np.asarray(yx_min[i]) * [h, w]
        y1, x1 = np.asarray(yx_max[i]) * [h, w]
        color = colors[c % len(colors)]
        draw.rectangle([x0, y0, x1, y1], outline=color, width=2)
        label = category[c] if category and c < len(category) else str(c)
        if conf is not None:
            label = f"{label} {float(np.atleast_1d(conf)[i]):.2f}"
        draw.text((x0 + 2, max(y0 - 12, 0)), label, fill=color)
    return np.asarray(pil)
