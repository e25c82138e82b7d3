"""PASCAL VOC annotation parser — a copy of ``yolojax/data/voc.py``, the
dataset module that ``[cache] datasets = yolojax.data.voc`` names.

Walks ``ImageSets/Main/<set>.txt`` of each configured VOC root
(``[cache] voc_roots``, e.g. VOC2007 + VOC2012) and parses
``Annotations/<id>.xml`` with ElementTree.  Boxes are converted from VOC's
1-based pixel corners to normalized yx [0, 1]; "difficult" objects are kept
but flagged (excluded from AP scoring per the VOC protocol).

Phase → image-set mapping follows the standard 07+12 recipe: ``train`` =
trainval of every root, ``val`` = val, ``test`` = test (only VOC2007 ships
one; roots without the set file are skipped).
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET

import numpy as np

from .cache import make_record

__all__ = ["load"]

_LOG = logging.getLogger(__name__)
_PHASE_SETS = {"train": "trainval", "val": "val", "test": "test"}


def parse_annotation(xml_path: str, image_path: str, name_to_idx: dict[str, int]) -> dict | None:
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = float(size.findtext("width"))
    h = float(size.findtext("height"))
    yx_min, yx_max, cls, difficult = [], [], [], []
    for obj in root.iter("object"):
        name = obj.findtext("name").strip()
        if name not in name_to_idx:
            continue
        box = obj.find("bndbox")
        # VOC pixel coordinates are 1-based inclusive corners
        xmin = float(box.findtext("xmin")) - 1
        ymin = float(box.findtext("ymin")) - 1
        xmax = float(box.findtext("xmax")) - 1
        ymax = float(box.findtext("ymax")) - 1
        yx_min.append((ymin / h, xmin / w))
        yx_max.append((ymax / h, xmax / w))
        cls.append(name_to_idx[name])
        difficult.append(obj.findtext("difficult", "0").strip() == "1")
    if not cls:
        return None
    return make_record(image_path, yx_min, yx_max, cls, difficult)


def load(config, phase: str, category: list[str]) -> list[dict]:
    name_to_idx = {n: i for i, n in enumerate(category)}
    records = []
    for root in config.get("cache", "voc_roots").split():
        root = os.path.expanduser(root)
        set_file = os.path.join(root, "ImageSets", "Main", f"{_PHASE_SETS[phase]}.txt")
        if not os.path.exists(set_file):
            _LOG.info("voc: %s has no %s set, skipping", root, _PHASE_SETS[phase])
            continue
        with open(set_file) as f:
            ids = [line.split()[0] for line in f if line.strip()]
        for image_id in ids:
            rec = parse_annotation(
                os.path.join(root, "Annotations", f"{image_id}.xml"),
                os.path.join(root, "JPEGImages", f"{image_id}.jpg"),
                name_to_idx)
            if rec is not None:
                records.append(rec)
    return records
