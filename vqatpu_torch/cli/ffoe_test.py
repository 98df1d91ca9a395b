"""FFOE inference and export CLI (``vqatpu/cli/ffoe_test.py``, reference
``src/FFOE/test.py``): load ``{--input}/model_epoch{--epoch}.ckpt``, sweep
``--split`` and write the EvalAI JSON, the CTI teacher-logit pkl for the
distillation loop, and with ``--logits`` the raw logits (``.npz``).
``--device_features`` (auto by default) sweeps with the split's features on
the card where they fit; ``--native_loader`` (the default) assembles host
batches in C++ otherwise.

Usage:  python -m vqatpu_torch.cli.ffoe_test --model cti --split val \\
            --input saved_models/cti --epoch 12 --results results
(``--device cpu`` runs on the CPU with the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vqatpu_torch.cli.common import (add_common_args, model_config_from_args,
                                     validate_args)
from vqatpu_torch.data.batching import make_eval_loader
from vqatpu_torch.data.datasets import TDIUCFeatureDataset, VQAFeatureDataset
from vqatpu_torch.data.device_store import (DeviceFeatureStore,
                                            devstore_decision)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.eval.ffoe import export_results, get_logits
from vqatpu_torch.models import build_model
from vqatpu_torch.train.checkpoints import load_params_any
from vqatpu_torch.weights import load_jax_params


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--split", type=str, default="test2015")
    parser.add_argument("--logits", type=bool, default=False)
    parser.add_argument("--debug", action="store_true", default=False,
                        help="echo the first question/predicted answer "
                             "(reference test.py:55-66)")
    parser.add_argument("--epoch", type=str, default="12")
    parser.add_argument("--results", type=str, default="results")
    parser.add_argument("--label", type=str, default="",
                        help="ensemble member tag: raw dumps go to "
                             "logits/<model><op><num_hid>_<label>/ "
                             "(reference test.py:172-175)")
    parser.add_argument("--index", type=int, default=0,
                        help="ensemble member index within --label")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    validate_args(args)
    if args.shard_feature_store:
        raise NotImplementedError(
            "the row-sharded device feature store (--shard_feature_store) "
            "spans several devices: not ported (ROADMAP queue A item 9)")
    dataroot = args.TDIUC_dir if args.use_TDIUC else args.dataroot
    dictionary = Dictionary.load_from_file(os.path.join(dataroot, "dictionary.pkl"))
    ds_cls = TDIUCFeatureDataset if args.use_TDIUC else VQAFeatureDataset
    eval_dset = ds_cls(args.split, dictionary, dataroot=dataroot,
                       max_boxes=args.max_boxes, question_len=args.question_len,
                       features_in_memory=not args.stream_features,
                       quantize_features=args.quantize_store)

    model = build_model(model_config_from_args(args, eval_dset))
    load_jax_params(model, load_params_any(args.input, args.epoch))
    model = model.to(args.device).eval()

    # the sweep with the features on the card (auto: where the split fits
    # the budget): the loader ships the fields and ds_idx, the eval gathers
    # v/b there; the logits are the wire path's
    dev_store = None
    build, why = devstore_decision(eval_dset, args.device_features,
                                   args.transfer_dtype, device=args.device)
    if build:
        dev_store = DeviceFeatureStore.build(
            eval_dset, transfer_dtype=args.transfer_dtype, device=args.device)
        print(f"device feature store: {dev_store.describe()}")
    elif why:
        print(f"device feature store OFF ({why}); using host wire")
    loader = make_eval_loader(eval_dset, args.batch_size,
                              use_native=args.native_loader,
                              quantize=(args.transfer_dtype == "int8"),
                              fields_only=dev_store is not None)
    try:
        logits, qids = get_logits(model, loader,
                                  compute_dtype=args.compute_dtype,
                                  transfer_dtype=args.transfer_dtype,
                                  dev_store=dev_store)
    finally:
        if hasattr(loader, "close"):
            loader.close()
    if args.debug:
        e = eval_dset.entries[0]
        idx2word = dictionary.idx2word
        toks = [idx2word[t] if t < len(idx2word) else "_" for t in e["q_token"]]
        print(" ".join(toks))
        print(eval_dset.label2ans[int(logits[0].argmax())])
    paths = export_results(args.results, args.split, args.model, args.op,
                           args.num_hid, args.epoch, logits, qids,
                           eval_dset.label2ans,
                           dump_teacher_logits=(args.model == "cti"))
    if args.logits:
        # raw logit dump (the reference saves a .pth tensor, test.py:173-175);
        # with --label the path mirrors its ensemble layout
        if args.label:
            member_dir = os.path.join(
                args.results, "logits",
                f"{args.model}{args.op}{args.num_hid}_{args.label}")
            os.makedirs(member_dir, exist_ok=True)
            raw = os.path.join(member_dir, f"logits{args.index}.npz")
            # the member path has no split component (test.py:172-175), so
            # a second split at the same label and index would overwrite
            if os.path.exists(raw):
                raise SystemExit(
                    f"refusing to overwrite {raw}: pick a different "
                    "--index (or --label) per member dump")
        else:
            raw = os.path.join(args.results,
                               f"{args.split}_{args.model}_logits.npz")
        np.savez(raw, logits=logits, question_ids=qids)
        paths["raw_logits"] = raw
    for kind, path in paths.items():
        print(f"wrote {kind}: {path}")
    return paths


if __name__ == "__main__":
    main()
