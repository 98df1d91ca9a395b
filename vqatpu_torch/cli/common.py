"""Shared CLI plumbing, a copy of ``vqatpu.cli.common``
(``vqatpu/cli/common.py:13-275``), preserving the reference's argparse
surface (``FFOE/main.py:21-79``, ``MC/main.py:21-76``, both ``test.py``)
with ``--device`` (default ``cuda``) for the device to run on.

Every flag of the JAX CLI is accepted.  A flag that only a JAX backend
gives meaning to (``--rng_impl``, ``--kernel_backend``,
``--compilation_cache_dir``) says so in its help and selects nothing here;
a flag whose machinery is not ported yet refuses the values that would
change what runs (``--coordinator``, ``--tp``, ``--num_devices`` > 1,
``--shard_feature_store``, ``--ckpt_backend orbax``, ``--profile_dir``,
``--mask_replay``, ``--fused_v_tucker`` with dropout, a ``--v_block_size``
below the box count).  The free-form models ``ban`` (``--use_counter``),
``san`` and ``cti`` are ported, with ``--distillation`` for BAN and SAN,
and ``mc_train``/``mc_test`` take the same flags for the multiple-choice
models.  No flag that changes results is ignored.  ``--native_loader``
(the default) assembles batches in the port's C++ runtime and ``--device_features auto`` (the default) puts the
features on the card where they fit; the log says what each decided and
why, as JAX's does."""

from __future__ import annotations

import argparse

from vqatpu_torch.config import ModelConfig, TrainConfig


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--epochs", type=int, default=13)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--num_hid", type=int, default=1024)
    parser.add_argument("--model", type=str, default="ban",
                        choices=["ban", "san", "cti", "stacked_attention"])
    parser.add_argument("--op", type=str, default="c")
    parser.add_argument("--use_both", action="store_true",
                        help="use both train/val splits to train")
    parser.add_argument("--use_vg", action="store_true",
                        help="augment with Visual Genome questions")
    parser.add_argument("--tfidf", type=bool, default=True)
    parser.add_argument("--input", type=str, default=None)
    parser.add_argument("--output", type=str, default="saved_models/ban")
    parser.add_argument("--clip_norm", default=0.25, type=float)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--update_freq", default="1")
    parser.add_argument("--gamma", type=int, default=2, help="glimpse")
    parser.add_argument("--max_boxes", default=50, type=int)
    parser.add_argument("--use_counter", action="store_true", default=False)
    parser.add_argument("--activation", type=str, default="relu",
                        choices=["relu", "swish"])
    parser.add_argument("--dropout", default=0.5, type=float)
    parser.add_argument("--question_len", default=12, type=int)
    parser.add_argument("--num_layers", default=1, type=int,
                        help="GRU stack depth (reference signature allows "
                             "it, language_model.py:51-66; builders use 1)")
    parser.add_argument("--seed", type=int, default=1204)
    parser.add_argument("--print_interval", default=200, type=int)
    parser.add_argument("--use_TDIUC", action="store_true", default=False)
    parser.add_argument("--TDIUC_dir", type=str, default="data_TDIUC")
    parser.add_argument("--dataroot", type=str, default="data_vqa")
    # CTI
    parser.add_argument("--rank", default=32, type=int)
    parser.add_argument("--h_out", default=1, type=int)
    parser.add_argument("--h_mm", default=512, type=int)
    parser.add_argument("--k", default=1, type=int)
    # Distillation
    parser.add_argument("--distillation", default=False, action="store_true")
    parser.add_argument("--T", default=1.5, type=float)
    parser.add_argument("--alpha", default=0.2, type=float)
    # SAN
    parser.add_argument("--num_stacks", default=2, type=int)
    # devices
    parser.add_argument("--device", type=str, default="cuda",
                        help="device to run on; cpu runs the kernels' plain "
                             "PyTorch versions")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="limit the data-parallel mesh size (the port "
                             "trains on one device: more is ROADMAP queue A "
                             "item 9)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel (model-axis) size: trains on a "
                             "2-D data x model mesh sharding the classifier "
                             "vocab, the PARALIND rank, and the t_net "
                             "tuckers (Megatron column/row pairing); not "
                             "ported: ROADMAP queue A item 9")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-host: coordinator address host:port "
                             "(one process per host); not ported: ROADMAP "
                             "queue A item 9")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-host: total process count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host: this process's id")
    parser.add_argument("--no_mesh", action="store_true",
                        help="run single-device (no data mesh; the port "
                             "always does)")
    parser.add_argument("--native_loader", action="store_true", default=True,
                        help="use the C++ prefetch data loader (the "
                             "default; it yields the Python loader's "
                             "batches; built at first use with the host's "
                             "g++ into vqatpu_torch/_build; a streaming "
                             "store takes the Python loader, said in the "
                             "log)")
    parser.add_argument("--no_native_loader", dest="native_loader",
                        action="store_false",
                        help="force the pure-Python BatchLoader")
    parser.add_argument("--stream_features", action="store_true",
                        default=False,
                        help="stream image features from the open HDF5 "
                             "instead of loading the whole file into RAM "
                             "(low-memory hosts; disables the native "
                             "loader's zero-copy path)")
    parser.add_argument("--quantize_store", action="store_true",
                        default=False,
                        help="keep the resident feature store int8 "
                             "(per-box symmetric quantization, loaded "
                             "chunk-wise — 4x less host RAM; composes "
                             "with --transfer_dtype int8, whose wire "
                             "bytes become pure memcpys)")
    parser.add_argument("--device_features", nargs="?", const="on",
                        default="auto", choices=("auto", "on", "off"),
                        help="upload the feature store to the card once and "
                             "gather v/b by index there (batches "
                             "bit-identical to the wire path): auto (the "
                             "default) where the tables fit half the card's "
                             "free memory (VQATPU_DEVSTORE_BUDGET_MB "
                             "overrides), on wherever the dataset is in "
                             "memory, off never; the log says why not")
    parser.add_argument("--shard_feature_store", action="store_true",
                        default=False,
                        help="row-shard the card's feature tables across "
                             "the mesh's data axis; implies "
                             "--device_features (not ported, ROADMAP queue A "
                             "item 9: raises)")
    parser.add_argument("--sparse_targets", action="store_true",
                        default=False,
                        help="with --device_features: ship targets as "
                             "(label, score) pairs, densified on the card "
                             "bit-identically")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace early train steps (not ported: ROADMAP "
                             "queue A item 10)")
    parser.add_argument("--kernel_backend", type=str, default="xla",
                        choices=["xla", "pallas"],
                        help="the JAX package's trilinear kernel path; "
                             "selects nothing here: the port has one path, "
                             "its CUDA kernels (JAX's pallas backend)")
    parser.add_argument("--ckpt_backend", type=str, default="pickle",
                        choices=["pickle", "orbax"],
                        help="checkpoint format (orbax = sharded/multi-host, "
                             "not ported: ROADMAP queue A item 9)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--skip_nonfinite", action="store_true", default=False,
                        help="zero the gradient of non-finite-loss "
                             "microbatches on-device (the reference's "
                             "overflow recovery, trainer.py:141-143)")
    parser.add_argument("--optim_state_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Adamax m/u storage dtype (bfloat16 halves the "
                             "optimizer's memory traffic; float32 = exact "
                             "torch trajectories)")
    parser.add_argument("--transfer_dtype", type=str, default="float32",
                        choices=["float32", "float16", "bfloat16", "int8"],
                        help="host->device wire dtype for the big feature "
                             "tensors v/b (f16/bf16 halve the copy; int8 "
                             "ships v quantized per box for a 4x cut, "
                             "dequantized on the card; only input "
                             "quantization differs from f32)")
    parser.add_argument("--rng_impl", type=str, default="rbg",
                        choices=["rbg", "threefry"],
                        help="the JAX package's dropout-mask PRNG; selects "
                             "nothing here: the port draws from a "
                             "torch.Generator on the device")
    parser.add_argument("--mask_bits", type=int, default=32, choices=[32, 16],
                        help="dropout mask source: 32 = exact bernoulli, "
                             "16 = 16-bit threshold draws (half the random "
                             "bits)")
    parser.add_argument("--mask_replay", action="store_true", default=False,
                        help="regenerate dropout masks in the backward "
                             "instead of saving them (not ported: autograd "
                             "keeps the masks; raises)")
    parser.add_argument("--fused_v_tucker", action="store_true", default=False,
                        help="one GEMM for the v-side tucker projections "
                             "(shared dropout mask; not ported: training "
                             "with dropout raises, ROADMAP queue A item 8)")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="rematerialize per-glimpse joint embeddings "
                             "(memory only, same results; not ported: "
                             "selects nothing here)")
    parser.add_argument("--v_block_size", type=int, default=0,
                        help="blockwise attention+pool over V blocks (0=off; "
                             "not ported: more boxes than this raise, "
                             "ROADMAP queue A item 8)")
    parser.add_argument("--compilation_cache_dir", type=str, default="",
                        help="the JAX package's persistent XLA compilation "
                             "cache; selects nothing here: the port "
                             "compiles no programs (its CUDA kernels build "
                             "once into vqatpu_torch/_build)")


def validate_args(args) -> None:
    """Early cross-flag validation (call right after parse_args): reject
    combinations that would otherwise fail deep inside dataset setup or
    select machinery the port does not have."""
    if getattr(args, "quantize_store", False) and \
            getattr(args, "stream_features", False):
        raise SystemExit(
            "error: --quantize_store and --stream_features are mutually "
            "exclusive (--quantize_store IS the low-RAM mode: int8-resident "
            "features, 4x less RAM than f32)")
    if getattr(args, "coordinator", None):
        raise NotImplementedError(
            "multi-process training (--coordinator) is not ported (ROADMAP "
            "queue A item 9)")


def model_config_from_args(args, dataset, task: str = "ffoe") -> ModelConfig:
    return ModelConfig(
        ntoken=dataset.dictionary.ntoken,
        v_dim=dataset.v_dim,
        num_ans_candidates=dataset.num_ans_candidates,
        model="san" if args.model == "stacked_attention" else args.model,
        num_hid=args.num_hid,
        op=args.op,
        gamma=args.gamma,
        activation=args.activation,
        dropout=args.dropout,
        num_layers=getattr(args, "num_layers", 1),
        use_counter=args.use_counter,
        num_stacks=args.num_stacks,
        h_mm=args.h_mm,
        h_out=args.h_out,
        rank=args.rank,
        k=args.k,
        task=task,
        kernel_backend=args.kernel_backend,
        v_block_size=args.v_block_size,
        remat_glimpse=args.remat,
        fused_v_tucker=getattr(args, "fused_v_tucker", False),
    )


def train_config_from_args(args, saving_epoch: int = 9) -> TrainConfig:
    return TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        clip_norm=args.clip_norm,
        update_freq=int(args.update_freq),
        seed=args.seed,
        saving_epoch=saving_epoch,
        distillation=args.distillation,
        T=args.T,
        alpha=args.alpha,
        compute_dtype=args.compute_dtype,
        optim_state_dtype=getattr(args, "optim_state_dtype", "float32"),
        transfer_dtype=getattr(args, "transfer_dtype", "float32"),
        skip_nonfinite=getattr(args, "skip_nonfinite", False),
        ckpt_backend=args.ckpt_backend,
        rng_impl=getattr(args, "rng_impl", "rbg"),
        mask_bits=getattr(args, "mask_bits", 32),
        mask_replay=getattr(args, "mask_replay", False),
        device_features=getattr(args, "device_features", "auto"),
        shard_feature_store=getattr(args, "shard_feature_store", False),
        sparse_targets=getattr(args, "sparse_targets", False),
    )
