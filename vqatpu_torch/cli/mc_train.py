"""Multiple-choice (Visual7W) training CLI (``vqatpu/cli/mc_train.py``,
reference ``src/MC/main.py``): ``--model cti|ban|san`` for TanModel,
BanModelMC (``--use_counter``) and SAN-MC on ``V7WDataset``'s train split,
evaluated on val each epoch; ``--use_feature grid`` takes the 196-cell
grid features.  The defaults are JAX's: ``--batch_size 64`` (questions; a
step takes their ``x4`` candidate rows), ``--output saved_models/v7w``,
``--dataroot data_v7w``, checkpoints from epoch 0 (``MC/train.py:29``);
``--tfidf`` initialises ``w_emb`` and ``wa_emb`` from the Visual7W
questions.  ``--device_features`` and ``--native_loader`` decide where
batches come from, as in ``ffoe_train``.  Fresh weights are drawn from
``--seed`` (:func:`vqatpu_torch.weights.numpy_params`).

Usage:  python -m vqatpu_torch.cli.mc_train --model cti --dataroot data_v7w ...
(``--device cpu`` runs on the CPU with the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os

from vqatpu_torch.cli.common import (add_common_args, end_distributed,
                                     maybe_init_distributed,
                                     model_config_from_args,
                                     train_config_from_args, validate_args)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.mc_dataset import V7WDataset
from vqatpu_torch.data.tfidf import tfidf_loading
from vqatpu_torch.models import build_model
from vqatpu_torch.parallel.distributed import process_index
from vqatpu_torch.train.checkpoints import restore_train_state
from vqatpu_torch.train.loop import train
from vqatpu_torch.train.steps import make_train_state


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--use_feature", type=str, default="bottom-up",
                        choices=["bottom-up", "grid"])
    parser.set_defaults(batch_size=64, output="saved_models/v7w",
                        dataroot="data_v7w")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    validate_args(args)
    started = maybe_init_distributed(args)
    try:
        return _main(args)
    finally:
        end_distributed(started)


def _main(args):
    dataroot = args.dataroot
    dictionary = Dictionary.load_from_file(
        os.path.join(dataroot, "dictionary.pkl"))
    common = dict(dataroot=dataroot, max_boxes=args.max_boxes,
                  question_len=args.question_len, use_feature=args.use_feature,
                  features_in_memory=not args.stream_features,
                  quantize_features=args.quantize_store)
    train_dset = V7WDataset("train", dictionary, **common)
    val_dset = V7WDataset("val", dictionary, **common)

    mcfg = model_config_from_args(args, train_dset, task="mc")
    tcfg = train_config_from_args(args, saving_epoch=0)  # MC/train.py:29
    model = build_model(mcfg)
    tfidf = bool(args.tfidf)
    state = make_train_state(model, seed=args.seed, tfidf_loaded=tfidf,
                             optim_state_dtype=tcfg.optim_state_dtype,
                             device=args.device)
    # on a mesh of several processes only rank 0 builds the tables (and
    # writes their cache): the loop gives every process rank 0's weights
    if tfidf and (args.no_mesh or process_index() == 0):
        for key in ("w_emb", "wa_emb"):
            if hasattr(model, key):
                tfidf_loading(getattr(model, key), dataroot, dictionary,
                              names=("train", "val", "test"),
                              target=("v7w",))

    start_epoch, best_eval = 0, 0.0
    if args.input is not None:
        state, start_epoch, ck_extra = restore_train_state(args.input, state)
        best_eval = float(ck_extra.get("best_eval", 0.0))

    return train(model, train_dset, val_dset, tcfg, args.output, task="mc",
                 state=state, start_epoch=start_epoch, best_eval=best_eval,
                 tfidf_loaded=tfidf, use_mesh=not args.no_mesh,
                 print_interval=args.print_interval,
                 use_native_loader=args.native_loader,
                 profile_dir=args.profile_dir,
                 num_devices=args.num_devices, tp=args.tp, device=args.device)


if __name__ == "__main__":
    main()
