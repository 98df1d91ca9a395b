"""TDIUC metric CLI (``vqatpu/cli/evaluate_tdiuc.py``, reference
``src/evaluate_TDIUC.py``): the MPT metrics of a predictions JSON against
the ground-truth annotations and an answerkey CSV.  Host only: it touches
no device.

Usage:  python -m vqatpu_torch.cli.evaluate_tdiuc --gt_ann ann.json \\
            --pred_ann results/val_ctic1024_epoch12.json --answerkey key.csv
"""

from __future__ import annotations

import argparse
import json

from vqatpu_torch.eval.tdiuc import (align_predictions, format_report,
                                     load_answerkey, mean_per_type)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_ann", required=True)
    parser.add_argument("--pred_ann", required=True)
    parser.add_argument("--answerkey", required=True)
    args = parser.parse_args(argv)

    answerkey = load_answerkey(args.answerkey)
    with open(args.gt_ann) as f:
        gt_ann = json.load(f)["annotations"]
    predictions = align_predictions(args.pred_ann, gt_ann, answerkey)
    metrics = mean_per_type(predictions, gt_ann, answerkey)
    print(format_report(metrics))
    return metrics


if __name__ == "__main__":
    main()
