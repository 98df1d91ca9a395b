"""Model configuration, a copy of ``vqatpu.config.ModelConfig``.

The fields and defaults are the JAX package's, so a configuration written
for one side constructs on the other.  ``kernel_backend``, ``v_block_size``,
``fused_v_tucker`` and ``remat_glimpse`` are kept for that reason only: the
port has one CTI path (the fused attention and pooling kernels), and the
blockwise, fused-tucker and remat variants are not ported yet (ROADMAP
queue A).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # dataset-derived
    ntoken: int
    v_dim: int
    num_ans_candidates: int
    # shared
    model: str = "ban"  # ban | san | cti
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
    # accepted for compatibility with the JAX package; selects nothing here
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
