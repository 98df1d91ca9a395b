"""Shared CLI plumbing, a copy of ``vqatpu.cli.common``
(``vqatpu/cli/common.py:13-275``), preserving the reference's argparse
surface (``FFOE/main.py:21-79``, ``MC/main.py:21-76``, both ``test.py``)
with ``--device`` (default ``cuda``) for the device to run on.

Every flag of the JAX CLI is accepted.  A flag that only a JAX backend
gives meaning to (``--rng_impl``, ``--kernel_backend``,
``--compilation_cache_dir``) says so in its help and selects nothing here;
``--ckpt_backend orbax`` writes JAX's orbax directories.
Several devices run one process each: ``--coordinator host:port
--num_processes N --process_id i`` join them
(:func:`maybe_init_distributed`; NCCL, or gloo with ``--device cpu``),
``--num_devices`` (N where given) and ``--tp`` shape the mesh, and
``--shard_feature_store`` row-shards the card's feature tables over its
data axis (:mod:`vqatpu_torch.parallel`).
``--v_block_size``, ``--remat`` and ``--fused_v_tucker`` select CTI's
blockwise, rematerialized and fused paths, as in JAX, and ``--profile_dir``
traces early training steps with ``torch.profiler``.  The free-form models
``ban`` (``--use_counter``), ``san`` and ``cti`` are ported, with ``--distillation`` for BAN and SAN,
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
                        help="the mesh size: the number of processes, one "
                             "a device (the default)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel (model-axis) size: trains on a "
                             "2-D data x model mesh sharding the classifier "
                             "vocab, the PARALIND rank, and the t_net "
                             "tuckers (Megatron column/row pairing)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="several processes, one a device: the "
                             "rendezvous address host:port (rank 0 serves "
                             "it; torch.distributed, NCCL on cuda, gloo on "
                             "cpu)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="several processes: their number (the world "
                             "size, one a device)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="several processes: this one's global rank")
    parser.add_argument("--no_mesh", action="store_true",
                        help="run single-device (no data mesh)")
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
                             "the mesh's data axis (stores bigger than one "
                             "card); implies --device_features")
    parser.add_argument("--sparse_targets", action="store_true",
                        default=False,
                        help="with --device_features: ship targets as "
                             "(label, score) pairs, densified on the card "
                             "bit-identically")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace steps 1 to min(6, batches - 1) of the "
                             "first epoch with torch.profiler (CUDA kernels "
                             "on the card) into this directory")
    parser.add_argument("--kernel_backend", type=str, default="xla",
                        choices=["xla", "pallas"],
                        help="the JAX package's trilinear kernel path; "
                             "selects nothing here: the port has one path, "
                             "its CUDA kernels (JAX's pallas backend)")
    parser.add_argument("--ckpt_backend", type=str, default="pickle",
                        choices=["pickle", "orbax"],
                        help="checkpoint format: .ckpt (pickle) or JAX's "
                             ".orbax directories (orbax); rank 0 writes the "
                             "whole state")
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
                             "from the generator's saved state instead of "
                             "saving them (bit-equal either way)")
    parser.add_argument("--fused_v_tucker", action="store_true", default=False,
                        help="one GEMM for CTI's v-side tucker projections "
                             "(one dropout mask on v for all of them; "
                             "ignored with --remat)")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="rematerialize CTI's per-glimpse joint "
                             "embeddings in the backward (memory only, same "
                             "results)")
    parser.add_argument("--v_block_size", type=int, default=0,
                        help="CTI's blockwise attention+pool over V blocks "
                             "of this size where there are more boxes (0 = "
                             "off); returns no attention map")
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


def maybe_init_distributed(args) -> bool:
    """Join the process group where ``--coordinator`` is given (the train
    CLIs call it first); -> True where it did, and the caller ends the
    group when it is done."""
    if not getattr(args, "coordinator", None):
        return False
    from vqatpu_torch.parallel.distributed import init_distributed

    assert args.num_processes and args.process_id is not None, \
        "--coordinator needs --num_processes and --process_id"
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     cpu_gloo=args.device == "cpu")
    return True


def end_distributed(started: bool) -> None:
    if started:
        import torch.distributed as dist

        dist.destroy_process_group()


def model_config_from_args(args, dataset, task: str = "ffoe") -> ModelConfig:
    return model_config_of(args, dataset.dictionary.ntoken, dataset.v_dim,
                           dataset.num_ans_candidates, task)


def model_config_of(args, ntoken: int, v_dim: int, num_ans: int,
                    task: str = "ffoe") -> ModelConfig:
    """The parsed flags' model config for a vocabulary of ``ntoken``,
    ``v_dim`` features and ``num_ans`` classes (serving has no dataset)."""
    return ModelConfig(
        ntoken=ntoken,
        v_dim=v_dim,
        num_ans_candidates=num_ans,
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
