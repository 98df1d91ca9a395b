"""Bottom-up-attention TSV -> HDF5 features
(``vqatpu/tools/feature_converter.py:33-136``, reference
``tools/detection_features_converter.py`` for the fixed 36 boxes and
``tools/adaptive_detection_features_converter.py`` for the adaptive 10-100
boxes).  Host only.

TSV rows: ``image_id, image_w, image_h, num_boxes, boxes`` (base64 float32
[n, 4]) and ``features`` (base64 float32 [n, 2048]).  The spatial features
are the 6-d scaled geometry ``(x1/w, y1/h, x2/w, y2/h, bw/w, bh/h)``
(``detection_features_converter.py:94-103``).

- :func:`convert_adaptive` writes ``{split}.hdf5`` with the flat
  ``image_features [total_boxes, 2048]``, ``image_bb``,
  ``spatial_features`` and ``pos_boxes [N, 2]`` (each image's row range),
  and ``{split}_imgid2idx.pkl``;
- :func:`convert_fixed` writes ``{split}{k}.hdf5`` with ``[N, k, 2048]``
  features and ``{split}{k}_imgid2idx.pkl``.

The arrays come from :func:`adaptive_arrays` and :func:`fixed_arrays`;
only the writers need ``h5py``, imported when one runs (as
:mod:`vqatpu_torch.data.features` imports it), and a missing ``h5py``
raises a named ``ImportError``.

Run: ``python -m vqatpu_torch.tools.feature_converter --split train --tsv
x.tsv --out data_vqa`` (``--fixed 36`` for the fixed-box layout).
"""

from __future__ import annotations

import argparse
import base64
import csv
import os
import pickle
import sys
from typing import Dict, Iterable, List, Tuple

import numpy as np

FIELDNAMES = ["image_id", "image_w", "image_h", "num_boxes", "boxes",
              "features"]
FEATURE_LENGTH = 2048


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError("feature_converter writes .hdf5 files and needs "
                          "h5py, which is not installed") from None
    return h5py


def decode_row(row: dict, feature_length: int = FEATURE_LENGTH):
    """-> ``(image_id, image_w, image_h, num_boxes, boxes [n, 4],
    features [n, feature_length])``."""
    num_boxes = int(row["num_boxes"])
    boxes = np.frombuffer(
        base64.b64decode(row["boxes"]), np.float32).reshape(num_boxes, 4)
    features = np.frombuffer(
        base64.b64decode(row["features"]), np.float32).reshape(
            num_boxes, feature_length)
    return (int(row["image_id"]), float(row["image_w"]),
            float(row["image_h"]), num_boxes, boxes, features)


def spatial_features(boxes: np.ndarray, image_w: float,
                     image_h: float) -> np.ndarray:
    """[n, 4] xyxy -> [n, 6] scaled (x1, y1, x2, y2, w, h), float32."""
    scaled_w = (boxes[:, 2] - boxes[:, 0]) / image_w
    scaled_h = (boxes[:, 3] - boxes[:, 1]) / image_h
    return np.column_stack([
        boxes[:, 0] / image_w, boxes[:, 1] / image_h,
        boxes[:, 2] / image_w, boxes[:, 3] / image_h,
        scaled_w, scaled_h,
    ]).astype(np.float32)


def iter_tsv(paths: Iterable[str]):
    csv.field_size_limit(sys.maxsize)
    for path in paths:
        with open(path, "r") as f:
            yield from csv.DictReader(f, delimiter="\t", fieldnames=FIELDNAMES)


def adaptive_arrays(tsv_files: List[str],
                    feature_length: int = FEATURE_LENGTH
                    ) -> Tuple[Dict[str, np.ndarray], Dict[int, int]]:
    """The adaptive layout's datasets (``image_features``, ``image_bb``,
    ``spatial_features``, ``pos_boxes`` int64) and ``img_id2idx``."""
    feats, spats, bbs, pos = [], [], [], []
    img_id2idx = {}
    offset = 0
    for row in iter_tsv(tsv_files):
        image_id, w, h, n, boxes, f_ = decode_row(row, feature_length)
        img_id2idx[image_id] = len(pos)
        pos.append([offset, offset + n])
        offset += n
        bbs.append(boxes)
        feats.append(f_)
        spats.append(spatial_features(boxes, w, h))
    return {"image_features": np.concatenate(feats, 0),
            "image_bb": np.concatenate(bbs, 0),
            "spatial_features": np.concatenate(spats, 0),
            "pos_boxes": np.asarray(pos, np.int64)}, img_id2idx


def fixed_arrays(tsv_files: List[str], num_fixed_boxes: int = 36,
                 feature_length: int = FEATURE_LENGTH
                 ) -> Tuple[Dict[str, np.ndarray], Dict[int, int]]:
    """The fixed-k layout's ``[N, k, ...]`` datasets and ``img_id2idx``;
    every image must have ``num_fixed_boxes`` boxes."""
    feats, spats, bbs = [], [], []
    img_id2idx = {}
    for row in iter_tsv(tsv_files):
        image_id, w, h, n, boxes, f_ = decode_row(row, feature_length)
        assert n == num_fixed_boxes, (image_id, n)
        img_id2idx[image_id] = len(feats)
        feats.append(f_)
        bbs.append(boxes)
        spats.append(spatial_features(boxes, w, h))
    return {"image_features": np.stack(feats, 0),
            "image_bb": np.stack(bbs, 0),
            "spatial_features": np.stack(spats, 0)}, img_id2idx


def _write(out_dir: str, stem: str, arrays: Dict[str, np.ndarray],
           img_id2idx: Dict[int, int]) -> None:
    h5py = _h5py()
    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(os.path.join(out_dir, f"{stem}.hdf5"), "w") as hf:
        for name, data in arrays.items():
            hf.create_dataset(name, data=data)
    with open(os.path.join(out_dir, f"{stem}_imgid2idx.pkl"), "wb") as f:
        pickle.dump(img_id2idx, f)


def convert_adaptive(split: str, tsv_files: List[str], out_dir: str,
                     feature_length: int = FEATURE_LENGTH) -> None:
    """The adaptive layout: flat features and ``pos_boxes`` ranges."""
    _h5py()  # before reading the TSVs
    arrays, img_id2idx = adaptive_arrays(tsv_files, feature_length)
    _write(out_dir, split, arrays, img_id2idx)
    print(f"{split}: {len(img_id2idx)} images, "
          f"{arrays['image_features'].shape[0]} boxes")


def convert_fixed(split: str, tsv_files: List[str], out_dir: str,
                  num_fixed_boxes: int = 36,
                  feature_length: int = FEATURE_LENGTH) -> None:
    """The fixed-k layout: ``[N, k, 2048]``."""
    _h5py()
    arrays, img_id2idx = fixed_arrays(tsv_files, num_fixed_boxes,
                                      feature_length)
    _write(out_dir, f"{split}{num_fixed_boxes}", arrays, img_id2idx)
    print(f"{split}: {len(img_id2idx)} images x {num_fixed_boxes} boxes")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--split", required=True)
    parser.add_argument("--tsv", nargs="+", required=True)
    parser.add_argument("--out", default="data_vqa")
    parser.add_argument("--fixed", type=int, default=None,
                        help="fixed box count (omit for adaptive layout)")
    args = parser.parse_args(argv)
    if args.fixed:
        convert_fixed(args.split, args.tsv, args.out, args.fixed)
    else:
        convert_adaptive(args.split, args.tsv, args.out)


if __name__ == "__main__":
    main()
