"""MS COCO annotation parser — a copy of ``yolojax/data/coco.py``, the dataset
module that ``config/coco.ini`` names.  ``instances_*.json`` is parsed with
the stdlib json (no pycocotools), which needs nothing beyond the documented
COCO schema.

Category ids are remapped to contiguous 0..C-1 by matching COCO category
*names* against the configured category list (the reference's remap
behavior); ``iscrowd`` annotations map to the ``difficult`` flag so the AP
protocol treats them like VOC difficult boxes.

Phase → split mapping: train → ``instances_train*.json``, val/test →
``instances_val*.json`` (COCO test has no public annotations).
"""

from __future__ import annotations

import glob
import json
import logging
import os

import numpy as np

from .cache import make_record

__all__ = ["load"]

_LOG = logging.getLogger(__name__)
_PHASE_SPLITS = {"train": "train", "val": "val", "test": "val"}


def _find_instances(root: str, split: str) -> list[str]:
    return sorted(glob.glob(os.path.join(root, "annotations", f"instances_{split}*.json")))


def parse_instances(path: str, image_dir_root: str, category: list[str]) -> list[dict]:
    with open(path) as f:
        db = json.load(f)
    name_to_idx = {n: i for i, n in enumerate(category)}
    cat_remap = {c["id"]: name_to_idx[c["name"]]
                 for c in db["categories"] if c["name"] in name_to_idx}
    # image dir from the json filename: instances_<split>.json → <split>/
    split = os.path.splitext(os.path.basename(path))[0].replace("instances_", "")
    by_image: dict[int, list] = {}
    for ann in db["annotations"]:
        if ann["category_id"] not in cat_remap:
            continue
        by_image.setdefault(ann["image_id"], []).append(ann)
    records = []
    for img in db["images"]:
        anns = by_image.get(img["id"])
        if not anns:
            continue
        w, h = float(img["width"]), float(img["height"])
        yx_min, yx_max, cls, difficult = [], [], [], []
        for ann in anns:
            x, y, bw, bh = ann["bbox"]  # pixel xywh
            yx_min.append((y / h, x / w))
            yx_max.append(((y + bh) / h, (x + bw) / w))
            cls.append(cat_remap[ann["category_id"]])
            difficult.append(bool(ann.get("iscrowd", 0)))
        records.append(make_record(
            os.path.join(image_dir_root, split, img["file_name"]),
            yx_min, yx_max, cls, difficult))
    return records


def load(config, phase: str, category: list[str]) -> list[dict]:
    root = os.path.expanduser(config.get("cache", "coco_root"))
    records = []
    for path in _find_instances(root, _PHASE_SPLITS[phase]):
        records.extend(parse_instances(path, root, category))
    if not records:
        _LOG.info("coco: no instances_%s*.json under %s", _PHASE_SPLITS[phase], root)
    return records
