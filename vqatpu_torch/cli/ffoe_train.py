"""FFOE training CLI (``vqatpu/cli/ffoe_train.py:42-114``, reference
``src/FFOE/main.py``): VQA-2.0 or ``--use_TDIUC`` datasets, ``--use_both``
and ``--use_vg``, the tf-idf GloVe init (``--tfidf``) and resume with
``--input``.  Fresh weights are drawn from ``--seed``
(:func:`vqatpu_torch.weights.numpy_params`, the port's counterpart of the
JAX ``model.init``), so the two packages start from different weights.

``--model ban|san|cti`` (``--use_counter`` adds BAN's counting branch;
``--distillation`` trains BAN or SAN against ``{split}_teacher_logits.pkl``
in the dataroot, the teacher's logits that ``ffoe_test --model cti``
writes, and is ignored by CTI, as in JAX).

Usage:  python -m vqatpu_torch.cli.ffoe_train --model cti --dataroot data_vqa ...
(``--device cpu`` runs on the CPU with the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import os

from vqatpu_torch.cli.common import (add_common_args, end_distributed,
                                     maybe_init_distributed,
                                     model_config_from_args,
                                     train_config_from_args, validate_args)
from vqatpu_torch.data.datasets import (ConcatDataset, TDIUCFeatureDataset,
                                        VisualGenomeFeatureDataset,
                                        VQAFeatureDataset)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.tfidf import tfidf_loading
from vqatpu_torch.models import build_model
from vqatpu_torch.parallel.distributed import process_index
from vqatpu_torch.train.checkpoints import restore_train_state
from vqatpu_torch.train.loop import train
from vqatpu_torch.train.steps import make_train_state


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
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
    dataroot = args.TDIUC_dir if args.use_TDIUC else args.dataroot
    dictionary = Dictionary.load_from_file(os.path.join(dataroot, "dictionary.pkl"))
    ds_cls = TDIUCFeatureDataset if args.use_TDIUC else VQAFeatureDataset
    common = dict(dataroot=dataroot, max_boxes=args.max_boxes,
                  question_len=args.question_len,
                  features_in_memory=not args.stream_features,
                  quantize_features=args.quantize_store)
    train_dset = ds_cls("train", dictionary, distillation=args.distillation,
                        **common)
    val_dset = ds_cls("val", dictionary, **common)

    mcfg = model_config_from_args(args, train_dset)
    tcfg = train_config_from_args(args, saving_epoch=9)
    model = build_model(mcfg)
    tfidf = bool(args.tfidf)
    state = make_train_state(model, seed=args.seed, tfidf_loaded=tfidf,
                             optim_state_dtype=tcfg.optim_state_dtype,
                             device=args.device)
    # tf-idf GloVe init on every word-embedding table
    # on a mesh of several processes only rank 0 builds the tables (and
    # writes their cache): the loop gives every process rank 0's weights
    if tfidf and (args.no_mesh or process_index() == 0):
        target = ("TDIUC",) if args.use_TDIUC else ("vqa",)
        names = ("train", "val") if args.use_TDIUC else ("train", "val", "test2015")
        for key in ("w_emb", "wa_emb"):  # CTI's answer stream has its own
            if hasattr(model, key):
                tfidf_loading(getattr(model, key), dataroot, dictionary,
                              names=names, target=target)

    start_epoch, best_eval = 0, 0.0
    if args.input is not None:
        state, start_epoch, ck_extra = restore_train_state(args.input, state)
        best_eval = float(ck_extra.get("best_eval", 0.0))

    if args.use_both:
        parts = [train_dset, val_dset]
        if args.use_vg:
            parts += [
                VisualGenomeFeatureDataset(split, dset.store, dictionary,
                                           dataroot=dataroot,
                                           max_boxes=args.max_boxes,
                                           img_id2idx=dset.img_id2idx)
                for split, dset in (("train", train_dset), ("val", val_dset))]
        train_ds, eval_ds = ConcatDataset(parts), None
    else:
        train_ds, eval_ds = train_dset, val_dset

    return train(model, train_ds, eval_ds, tcfg, args.output,
                 state=state, start_epoch=start_epoch, best_eval=best_eval,
                 tfidf_loaded=tfidf, use_mesh=not args.no_mesh,
                 print_interval=args.print_interval,
                 use_native_loader=args.native_loader,
                 profile_dir=args.profile_dir,
                 num_devices=args.num_devices, tp=args.tp, device=args.device)


if __name__ == "__main__":
    main()
