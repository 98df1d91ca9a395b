"""``TrainConfig(mask_replay=True)`` on the CPU: dropout keeps the
generator's state instead of the mask and draws the mask again in the
backward (JAX's ``_dropout_replay``, ``vqatpu/ops/module.py:123-140``).

- ``dropout`` alone, for ``mask_bits`` 16 and 32, whole and as a
  tensor-parallel shard, float32 and bf16: the output, the input's
  cotangent and the generator's state afterwards are bit-equal to the plain
  path's, and autograd keeps no tensor of the input's size (the plain path
  keeps the mask).
- ``checkpoint_with_dropout`` passes the flag on to both runs' contexts.
- A small-width CTI training step, dropout on: two steps of loss, grad norm
  and params bit-equal to ``mask_replay=False`` from the same seeded
  generator, float32 and bf16, on the standard, ``remat_glimpse`` and
  blockwise paths.  JAX asserts the same equality for its own version
  (``tests/test_ops_linear.py::test_dropout_mask_replay_bit_equal``).
- ``ffoe_train --mask_replay`` runs, and logs the epoch's numbers of the
  run without it.
"""

import os

import numpy as np
import pytest
import torch

from vqatpu_torch.cli import ffoe_train
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data.synthetic import make_vqa_fixture
from vqatpu_torch.models import build_model
from vqatpu_torch.ops.module import Ctx, checkpoint_with_dropout, dropout
from vqatpu_torch.train import make_train_state, make_train_step
from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params

SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)  # tests/test_models.py
SHAPE = (3, 7, 16)
RATE = 0.3


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so that equality also tells -0.0 from 0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def run_dropout(x0, g, mask_bits, shard, replay):
    """-> (output, input cotangent, the generator's state afterwards, the
    shapes autograd packed for the backward)."""
    gen = torch.Generator().manual_seed(5)
    x = x0.clone().requires_grad_()
    packed = []

    def pack(t):
        packed.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = dropout(x, RATE, Ctx(train=True, generator=gen,
                                 mask_bits=mask_bits, mask_replay=replay),
                    shard)
    y.backward(g)
    return y.detach(), x.grad, gen.get_state(), packed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", [None, (2, 0), (2, 1)])
@pytest.mark.parametrize("mask_bits", [16, 32])
def test_replay_dropout_is_bit_equal_and_keeps_no_mask(mask_bits, shard,
                                                       dtype):
    rs = np.random.RandomState(mask_bits + (0 if shard is None else shard[1]))
    x0 = torch.from_numpy(rs.randn(*SHAPE).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rs.randn(*SHAPE).astype(np.float32)).to(dtype)
    plain = run_dropout(x0, g, mask_bits, shard, replay=False)
    replay = run_dropout(x0, g, mask_bits, shard, replay=True)
    assert torch.equal(bits(replay[0]), bits(plain[0]))
    assert torch.equal(bits(replay[1]), bits(plain[1]))
    assert torch.equal(replay[2], plain[2])
    # a dropout keeps some and zeroes some
    assert 0 < int((plain[0] == 0).sum()) < plain[0].numel()
    assert SHAPE in plain[3]      # the plain path keeps the mask
    assert replay[3] == []        # the replay keeps no tensor at all


def test_remat_sub_contexts_carry_mask_replay():
    seen = []

    def fn(c, x):
        seen.append(c.mask_replay)
        return dropout(x, RATE, c) ** 2  # keeps its input: a recompute

    for replay in (False, True):
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(4, 8, requires_grad=True)
        checkpoint_with_dropout(fn, Ctx(train=True, generator=gen,
                                        mask_replay=replay), x).sum().backward()
    assert seen == [False, False, True, True]  # forward, then the recompute


def port_cti(kw, params):
    return load_jax_params(build_model(ModelConfig(**kw)), params)


@pytest.mark.parametrize("knob", [{}, dict(remat_glimpse=True),
                                  dict(v_block_size=4)],
                         ids=["standard", "remat_glimpse", "blockwise"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_replay_step_equals_the_plain_step(compute_dtype, knob):
    """Two steps with dropout on, the generator seeded alike: losses, grad
    norms and params bit-equal with and without ``mask_replay``."""
    kw = dict(SMALL, **knob)
    cfg = ModelConfig(**kw)
    params = numpy_params(cfg, seed=4)
    batch = numpy_batch(cfg, 3, seed=2, boxes=8, real_boxes=6, target=True)
    batch = {k: torch.from_numpy(t) for k, t in batch.items()}
    out = []
    for replay in (False, True):
        model = port_cti(kw, params)
        state = make_train_state(model, device="cpu")
        step = make_train_step(model, TrainConfig(
            update_freq=1, deterministic=False, mask_replay=replay,
            compute_dtype=compute_dtype))
        gen = torch.Generator().manual_seed(9)
        ms = [step(state, batch, 1e-3, generator=gen) for _ in range(2)]
        out.append(([(float(m["loss"]), float(m["grad_norm"])) for m in ms],
                    [p.detach().clone() for p in model.parameters()],
                    gen.get_state()))
    assert out[1][0] == out[0][0]
    assert all(norm > 0 for _, norm in out[0][0])  # both steps updated
    for a, b in zip(out[1][1], out[0][1]):
        assert torch.equal(bits(a), bits(b))
    assert torch.equal(out[1][2], out[0][2])


def test_ffoe_train_mask_replay_runs(tmp_path):
    """One epoch of two steps through the CLI, with dropout on: the log
    shows the flag, and the epoch's loss, norm and score equal the run
    without it."""
    root = str(tmp_path / "data_vqa")
    make_vqa_fixture(root, n_train=8, n_val=4, n_images=4, v_dim=16)
    logs = []
    for extra in ([], ["--mask_replay"]):
        out = str(tmp_path / ("replay" if extra else "plain"))
        ffoe_train.main(["--model", "cti", "--dataroot", root, "--output",
                         out, "--epochs", "1", "--num_hid", "16", "--h_mm",
                         "8", "--rank", "2", "--batch_size", "4",
                         "--max_boxes", "12", "--device", "cpu",
                         "--no_native_loader", *extra])
        with open(os.path.join(out, "log.txt")) as f:
            logs.append(f.read())
    assert "mask_replay=True" in logs[1] and "mask_replay=False" in logs[0]
    losses = [[ln for ln in log.splitlines() if "train_loss" in ln]
              for log in logs]
    assert len(losses[0]) == 1 and losses[1] == losses[0]
