"""Multiple-choice (Visual7W) evaluation CLI (``vqatpu/cli/mc_test.py``,
reference ``src/MC/test.py``): load ``{--input}/model_epoch{--epoch}.ckpt``
(else ``.orbax``, else ``.pth``),
sweep ``--split`` (``test`` by default) with the ``x4`` candidate
expansion and print ``{split} accuracy: ...``.  ``--device_features``
(auto by default) sweeps with the split's features on the card where they
fit, the loader shipping row indices that the expansion repeats;
``--native_loader`` (the default) assembles host batches in C++ otherwise.

Usage:  python -m vqatpu_torch.cli.mc_test --model cti --split test \\
            --input saved_models/v7w --epoch 12
(``--device cpu`` runs on the CPU with the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os

from vqatpu_torch.cli.common import (add_common_args, model_config_from_args,
                                     validate_args)
from vqatpu_torch.data.batching import make_eval_loader
from vqatpu_torch.data.device_store import (DeviceFeatureStore,
                                            devstore_decision)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.mc_dataset import V7WDataset
from vqatpu_torch.eval.mc import evaluate_mc
from vqatpu_torch.models import build_model
from vqatpu_torch.train.checkpoints import load_params_any
from vqatpu_torch.weights import load_jax_params


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--epoch", type=str, default="12")
    parser.add_argument("--use_feature", type=str, default="bottom-up",
                        choices=["bottom-up", "grid"])
    parser.set_defaults(batch_size=64, dataroot="data_v7w")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    """-> the split's accuracy (a fraction), as printed in percent."""
    args = parse_args(argv)
    validate_args(args)
    dictionary = Dictionary.load_from_file(
        os.path.join(args.dataroot, "dictionary.pkl"))
    eval_dset = V7WDataset(args.split, dictionary, dataroot=args.dataroot,
                           max_boxes=args.max_boxes,
                           question_len=args.question_len,
                           use_feature=args.use_feature,
                           features_in_memory=not args.stream_features,
                           quantize_features=args.quantize_store)

    model = build_model(model_config_from_args(args, eval_dset, task="mc"))
    load_jax_params(model, load_params_any(args.input, args.epoch, model))
    model = model.to(args.device).eval()

    dev_store = None
    build, why = devstore_decision(eval_dset, args.device_features,
                                   args.transfer_dtype, task="mc",
                                   shard=args.shard_feature_store,
                                   device=args.device)
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
        acc, _ = evaluate_mc(model, loader, compute_dtype=args.compute_dtype,
                             transfer_dtype=args.transfer_dtype,
                             dev_store=dev_store)
    finally:
        if hasattr(loader, "close"):
            loader.close()
    print(f"{args.split} accuracy: {100 * acc:.2f}")
    return acc


if __name__ == "__main__":
    main()
