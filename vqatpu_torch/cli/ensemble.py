"""Ensemble combiner CLI (``vqatpu/cli/ensemble.py:28-66``): average the
raw-logit dumps of several members into one EvalAI JSON.

The reference dumps each member's raw logits (``FFOE/test.py:172-175``,
driven by ``--label``/``--index``) and averages them offline; this is that
step over ``ffoe_test --logits`` ``.npz`` dumps, with the JAX CLI's file
names::

    python -m vqatpu_torch.cli.ffoe_test --logits 1 --label sweep --index 0 ...
    python -m vqatpu_torch.cli.ffoe_test --logits 1 --label sweep --index 1 ...
    python -m vqatpu_torch.cli.ensemble \\
        --inputs results/logits/ctic1024_sweep/logits*.npz \\
        --dataroot data_vqa --split test2015

``--teacher_pkl`` also writes the averaged logits as a CTI teacher pkl
(``{qid: float16 logits}``, the input of ``VQAFeatureDataset(
distillation=True)``).  Host only: it touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

from vqatpu_torch.eval.ffoe import (ensemble_logits, make_json,
                                    make_json_with_logits)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--inputs", nargs="+", required=True,
                        help="raw-logit npz dumps (ffoe_test --logits)")
    parser.add_argument("--dataroot", type=str, default="data_vqa",
                        help="dataroot holding cache/trainval_label2ans.pkl")
    parser.add_argument("--split", type=str, default="test2015")
    parser.add_argument("--results", type=str, default="results")
    parser.add_argument("--name", type=str, default="ensemble",
                        help="tag for the output JSON filename")
    parser.add_argument("--teacher_pkl", action="store_true", default=False,
                        help="also dump {qid: float16 logits} teacher pkl "
                             "from the averaged logits (KD-loop input)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logits, qids = ensemble_logits(args.inputs)
    with open(os.path.join(args.dataroot, "cache",
                           "trainval_label2ans.pkl"), "rb") as f:
        label2ans = pickle.load(f)
    os.makedirs(args.results, exist_ok=True)
    paths = {"json": os.path.join(
        args.results,
        f"{args.split}_{args.name}_{len(args.inputs)}members.json")}
    with open(paths["json"], "w") as f:
        json.dump(make_json(logits, qids, label2ans), f)
    print(f"wrote ensemble json: {paths['json']}")
    if args.teacher_pkl:
        paths["teacher_logits"] = os.path.join(
            args.results, f"{args.name}_{args.split}_logits.pkl")
        with open(paths["teacher_logits"], "wb") as f:
            pickle.dump(make_json_with_logits(logits, qids), f)
        print(f"wrote teacher logits: {paths['teacher_logits']}")
    return paths


if __name__ == "__main__":
    main()
