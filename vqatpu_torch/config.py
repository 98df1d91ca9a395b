"""Model and training configuration, copies of ``vqatpu.config.ModelConfig``
and ``vqatpu.config.TrainConfig``.

The fields and defaults are the JAX package's, so a configuration written
for one side constructs on the other; the default model, ``ban``, builds.
Every model is ported: for ``task="ffoe"`` ``ban`` (``use_counter``,
``objects``), ``san`` (``num_stacks``) and ``cti``; for ``task="mc"``
(Visual7W, a 2-class head: :attr:`ModelConfig.num_classes`) ``ban``,
``san`` and ``cti`` or ``tan`` (TanModel).  CTI and TanModel have one
path, that of JAX's ``kernel_backend="pallas"`` (the fused attention and
pooling kernels, and its dtypes at bf16 compute); ``kernel_backend``
selects nothing here.  JAX's free-form CTI reads the three v-side knobs,
and so does the port's (:class:`vqatpu_torch.models.ffoe.CTIModel`):
``v_block_size`` > 0 with more boxes than it selects the blockwise large-V
path, which returns no attention (``vqatpu/models/ffoe.py:357``);
``fused_v_tucker`` runs the 1+γ v-side tuckers as one GEMM and, with
dropout, draws one mask on ``v`` for them (``vqatpu/config.py:47-50``);
``remat_glimpse`` recomputes each glimpse's joint embedding in the
backward (memory only, the same results) and overrides
``fused_v_tucker``.  JAX's TanModel reads none of them, and neither does
the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # dataset-derived
    ntoken: int
    v_dim: int
    num_ans_candidates: int
    # shared
    model: str = "ban"  # ban | san | cti (| tan for mc)
    num_hid: int = 1024
    op: str = "c"  # 'c' => concat frozen GloVe copy (600-d words)
    gamma: int = 2  # glimpses
    activation: str = "relu"
    dropout: float = 0.5
    num_layers: int = 1  # GRU stack depth
    use_counter: bool = False
    objects: int = 10
    num_stacks: int = 2
    # CTI
    h_mm: int = 512
    h_out: int = 1
    rank: int = 32
    k: int = 1
    task: str = "ffoe"  # ffoe | mc
    # JAX's kernel path (selects nothing here) and CTI's v-side knobs (see
    # the docstring)
    kernel_backend: str = "xla"
    v_block_size: int = 0
    fused_v_tucker: bool = False
    remat_glimpse: bool = False

    @property
    def word_dim(self) -> int:
        return 600 if "c" in self.op else 300

    @property
    def num_classes(self) -> int:
        return 2 if self.task == "mc" else self.num_ans_candidates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration, a copy of ``vqatpu.config.TrainConfig`` with
    the same fields and defaults.

    ``rng_impl`` and ``data_axis`` select TPU machinery of the JAX package
    and nothing here.  The epoch loop (:func:`vqatpu_torch.train.loop.
    train`) reads the rest: ``device_features`` (``"auto"``, ``"on"``,
    ``"off"``) decides whether the features go to the card
    (:mod:`vqatpu_torch.data.device_store`, with ``sparse_targets``;
    ``shard_feature_store`` row-shards it over the mesh's data axis), while
    ``ckpt_backend="orbax"`` (JAX's format) raises.  ``compute_dtype`` (float32 or bfloat16) and
    ``transfer_dtype`` (float32, float16, bfloat16 or int8) are ported.  ``distillation``
    applies to BAN and SAN only (``vqatpu/train/steps.py:208``), so the CTI
    step ignores it, as JAX's does.  ``mask_replay`` keeps no dropout mask
    for the backward: it draws each again from the generator's saved state
    (:func:`vqatpu_torch.ops.module.dropout`), bit-equal to keeping it.
    """

    epochs: int = 13
    batch_size: int = 256
    lr: float = 1e-3
    clip_norm: float = 0.25
    update_freq: int = 4
    seed: int = 1204
    saving_epoch: int = 9
    # LR schedule (FFOE/train.py:26-31)
    warmup_factors: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0)
    lr_decay_start: int = 10
    lr_decay_end: int = 20
    lr_decay_step: int = 2
    lr_decay_rate: float = 0.25
    # distillation
    distillation: bool = False
    T: float = 1.5
    alpha: float = 0.2
    compute_dtype: str = "float32"
    data_axis: str = "data"
    rng_impl: str = "rbg"
    # Adamax m/u storage: "bfloat16" stores them rounded to nearest even;
    # the update math runs in float32 either way
    optim_state_dtype: str = "float32"
    # 32: Bernoulli(keep) masks; 16: thresholded 16-bit draws with the
    # exact realized keep probability in the scale
    mask_bits: int = 32
    mask_replay: bool = False
    ckpt_backend: str = "pickle"
    # True turns dropout off in the train step (trajectory-parity runs)
    deterministic: bool = False
    # a non-finite microbatch contributes a zero gradient and reports
    # metrics["skipped"] = 1; the update cadence is unchanged
    skip_nonfinite: bool = False
    transfer_dtype: str = "float32"
    device_features: str = "auto"
    shard_feature_store: bool = False
    # sparse (t_label, t_score) targets, densified in the step
    sparse_targets: bool = False
