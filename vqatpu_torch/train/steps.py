"""Train and eval steps (``vqatpu/train/steps.py:29-353``), the
reference's ``Trainer`` hot loop (``FFOE/trainer.py:97-272``).

- :func:`make_train_state` freezes the GloVe copy ``emb_`` unless
  ``tfidf_loaded`` (``requires_grad_(False)``: no gradient, no Adamax state,
  no update, nothing in the clip norm; ``steps.py:54-71, 92-96``) and builds
  the optimizer over the other parameters.
- :func:`make_train_step` returns ``step(state, batch, lr, generator,
  force_update=False) -> metrics``.  The loss is ``bce_with_logits_sum /
  B``, or with ``distillation`` for BAN and SAN the distillation loss
  against the batch's ``t_logits`` (upcast to float32; ``steps.py:208,
  233-235``).  Each microbatch's gradients are taken with
  ``torch.autograd.grad`` and added to explicit buffers, so that
  ``skip_nonfinite`` can drop one non-finite microbatch (a zero gradient,
  cadence unchanged).  Every ``update_freq``-th microbatch, or on
  ``force_update``, the summed gradients are divided by the microbatch
  count, clipped to ``clip_norm`` by their global norm and applied by
  Adamax.  The metrics (``loss``, the
  pre-clip ``grad_norm``, 0 on a step that does not update,
  ``batch_score``, ``updated``, ``skipped``) are tensors on the model's
  device: the step never waits for the card.  With ``mc_scoring``
  (multiple choice, ``x4``-expanded rows with 2-class targets, which the
  densify step passes through) ``batch_score`` is the group accuracy
  :func:`compute_score_mc` (``steps.py:304-305``).
- ``deterministic=True`` turns dropout off; otherwise dropout draws from
  the step's ``generator`` (a ``torch.Generator`` on the model's device),
  or from the masks of ``ctx_factory``'s :class:`~vqatpu_torch.ops.module.
  MaskSource`.

The update cadence is decided on the host (the microbatch count is known
there), where the JAX step uses ``lax.cond``.  Compute is float32 with TF32
off for cuBLAS and cuDNN, as in serving (:mod:`vqatpu_torch.numerics`).

``compute_dtype="bfloat16"`` casts the float32 master parameters to bf16
inside the differentiated forward (``torch.func.functional_call``,
``steps.py:225-231``), with ``v`` cast to bf16 and the spatials ``b``
left float32; gradients, the clip, Adamax, the loss and the logits stay
float32, and the model is never converted.  ``transfer_dtype`` narrows a host batch before its copy
(:func:`wire_cast`: float16, bfloat16, or int8 ``v`` with a ``v_scale`` and
float16 ``b``); a batch whose values are all tensors on the model's device
has been through the wire already (the training loop's upload, the
card-resident store's gather) and is taken as it is.  The step dequantizes
and upcasts on the card (:func:`upcast_wire`) before it computes.  Eval takes ``compute_dtype``
too and accepts wire-cast batches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from vqatpu_torch.config import TrainConfig
from vqatpu_torch.data.native import quantize_rows
from vqatpu_torch.numerics import check_f32_math, require_f32_math
from vqatpu_torch.ops.losses import bce_with_logits_sum, distillation_loss
from vqatpu_torch.ops.module import Ctx
from vqatpu_torch.parallel.sharding import split_flags
from vqatpu_torch.train.optim import Adamax, clip_flat_grads
from vqatpu_torch.weights import load_jax_params, numpy_params


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Adamax
    grad_accum: Optional[List[torch.Tensor]] = None  # summed microbatch grads
    accum_count: int = 0  # microbatches buffered since the last update
    step: int = 0  # optimizer updates taken


def compute_score_with_logits(logits: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    """VQA soft accuracy: the target's score at the argmax, summed
    (``FFOE/train.py:16-21``)."""
    return target.gather(1, logits.argmax(1, keepdim=True)).sum()


def compute_score_mc(logits: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """Multiple-choice group accuracy (``vqatpu/train/steps.py:45-51``,
    ``MC/train.py:14-19``): per group of 4 candidate rows, the row of the
    largest class-0 margin ``logit0 - logit1`` (the argmax of the match
    probability) is picked, and its label ``target[:, 0]`` is scored."""
    margin = (logits[:, 0] - logits[:, 1]).reshape(-1, 4)
    pick = margin.argmax(1, keepdim=True)
    return target[:, 0].reshape(-1, 4).gather(1, pick).sum()


def densify_target(batch: dict, n_ans: int) -> dict:
    """Sparse ``t_label`` [B, K] / ``t_score`` [B, K] -> dense ``target``
    [B, n_ans] (``steps.py:152-170``).  Each label of a row is distinct, so
    every column receives at most one nonzero score; the zero-score pads add
    0 to column 0.  Bit-identical to the host-dense target."""
    if "t_label" not in batch:
        return batch
    batch = dict(batch)
    lab = torch.as_tensor(batch.pop("t_label")).long()
    sc = torch.as_tensor(batch.pop("t_score")).float()
    target = torch.zeros(lab.shape[0], n_ans, dtype=torch.float32,
                         device=lab.device)
    batch["target"] = target.scatter_add_(1, lab, sc.to(lab.device))
    return batch


def _on_device(batch: dict, dev: torch.device) -> dict:
    out = {}
    for k, x in batch.items():
        x = torch.as_tensor(x).to(dev)
        out[k] = x.long() if k in ("q", "a") else x
    return out


_STATE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
WIRES = ("float32", "float16", "bfloat16", "int8")


def _to_bf16(x) -> torch.Tensor:
    """A host bf16 tensor, rounded to nearest even (numpy has no bf16)."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def wire_cast(db: dict, transfer_dtype: str = "float32") -> dict:
    """The host half of the wire (``steps.py:124-149``): shrink ``v`` and
    ``b`` before they are copied to the card.  ``int8`` ships ``v``
    quantized per box by the C++ quantizer
    (:func:`~vqatpu_torch.data.native.quantize_rows`, JAX's ``quantize_v``)
    with a float32 ``v_scale`` and ``b`` as float16; a ``v`` that already
    has its ``v_scale`` passes through untouched.  ``float16`` gives numpy
    arrays, ``bfloat16`` host torch tensors."""
    if transfer_dtype == "float32":
        return db
    if transfer_dtype == "int8":
        out = dict(db)
        if "v" in db and "v_scale" not in db:
            out["v"], out["v_scale"] = quantize_rows(db["v"])
        if "b" in db:
            out["b"] = np.asarray(db["b"]).astype(np.float16)
        return out
    if transfer_dtype == "float16":
        def cast(x):
            return np.asarray(x).astype(np.float16)
    elif transfer_dtype == "bfloat16":
        cast = _to_bf16
    else:
        raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; "
                         f"expected one of {WIRES}")
    return dict(db, **{k: cast(db[k]) for k in ("v", "b") if k in db})


def upcast_wire(batch: dict) -> dict:
    """The card's half of the wire (``steps.py:173-189``): dequantize an
    int8 ``v`` with its ``v_scale`` (dropped here), and upcast float16 or
    bf16 ``v`` and ``b`` to float32."""
    if "v_scale" in batch:
        batch = dict(batch)
        scale = batch.pop("v_scale")
        batch["v"] = batch["v"].float() * scale[..., None]
    cast = {k: batch[k].float() for k in ("v", "b")
            if k in batch and batch[k].dtype in (torch.float16, torch.bfloat16)}
    return dict(batch, **cast) if cast else batch


def _check_compute_dtype(compute_dtype: str):
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; expected "
                         f"one of {tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[compute_dtype]


def forward_in(model: nn.Module, half, batch: dict, ctx=None):
    """``model``'s forward on a batch on its device, float32 logits: the
    batch's ``v``, ``q``, ``a``, ``v_mask`` and ``b``, each model reading
    those it needs.  With ``half`` (bf16) the parameters are cast inside
    the call, so autograd carries their gradients back to the float32
    masters, and ``v`` is cast too; ``b`` stays float32
    (``steps.py:225-231``)."""
    v = batch["v"] if half is None else batch["v"].to(half)
    args = (v, batch["q"], batch.get("a"), batch.get("v_mask"), ctx)
    kwargs = {"b": batch.get("b")}
    if half is None:
        logits, _ = model(*args, **kwargs)
    else:
        params = {n: p.to(half) for n, p in model.named_parameters()}
        logits, _ = functional_call(model, params, args, kwargs)
    return logits.float()


def make_train_state(model: nn.Module, seed: Optional[int] = None,
                     tfidf_loaded: bool = False,
                     optim_state_dtype: str = "float32",
                     device: Union[str, torch.device] = "cuda") -> TrainState:
    """Move ``model`` to ``device`` and build its optimizer, whose Adamax
    state is stored in ``optim_state_dtype`` (the step's
    ``TrainConfig.optim_state_dtype`` must name the same).  ``seed`` draws
    fresh weights with :func:`vqatpu_torch.weights.numpy_params` (the
    counterpart of the JAX ``model.init(key)``); None keeps the model's
    weights."""
    if optim_state_dtype not in _STATE_DTYPES:
        raise ValueError(f"unknown optim_state_dtype {optim_state_dtype!r}")
    model = model.to(device)
    if seed is not None:
        load_jax_params(model, numpy_params(model.cfg, seed))
    for name, p in model.named_parameters():
        p.requires_grad_(tfidf_loaded or name.split(".")[-1] != "emb_")
    params = [p for p in model.parameters() if p.requires_grad]
    # cuDNN's GRU backward needs train mode; dropout follows the Ctx alone
    model.train()
    return TrainState(model, Adamax(
        params, state_dtype=_STATE_DTYPES[optim_state_dtype]))


def reduce_grads(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The gradients summed over ``group`` (a data axis), as one flat
    all-reduce."""
    if group is None or group.size == 1:
        return grads
    flat = group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    return [t.view_as(g) for t, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(model: nn.Module, cfg: TrainConfig,
                    tfidf_loaded: bool = False, mc_scoring: bool = False,
                    ctx_factory: Optional[Callable[[], Ctx]] = None,
                    mesh=None):
    """Build the train step for ``model``, after :func:`make_train_state`
    has frozen its parameters with the same ``tfidf_loaded`` and built its
    optimizer with ``cfg.optim_state_dtype`` (see the module docstring; the
    step raises on a state with other Adamax storage).  ``ctx_factory``
    (zero-argument -> :class:`Ctx`) replaces the step's own context: the
    mask-injection hook of the parity tests.

    ``mesh`` (:class:`vqatpu_torch.parallel.sharding.Mesh`): several
    processes.  Each takes its data index's rows of the global batch, and
    its loss is divided by ``dp`` as well, so that the gradients summed
    over the data axis are those of JAX's loss over the global batch,
    ``bce_with_logits_sum / B``.  The sum is one flat all-reduce at each
    update, after the local accumulation.  Under tensor parallelism
    (:func:`~vqatpu_torch.parallel.sharding.shard_model`) the clip's norm
    adds the squares of split gradients over the model axis and counts
    replicated ones once.  The metrics are the global batch's: the loss and
    the batch score are summed over the data axis, and ``skip_nonfinite``
    tests the global loss."""
    half = _check_compute_dtype(cfg.compute_dtype)
    if cfg.transfer_dtype not in WIRES:
        raise ValueError(f"unknown transfer_dtype {cfg.transfer_dtype!r}; "
                         f"expected one of {WIRES}")
    mcfg = model.cfg
    if cfg.mask_replay:
        raise NotImplementedError(
            "mask_replay is not ported: autograd keeps the dropout mask "
            "(ROADMAP queue A item 1)")
    if any(p.requires_grad != tfidf_loaded for n, p in model.named_parameters()
           if n.split(".")[-1] == "emb_"):
        raise ValueError(f"the GloVe copy emb_ is not frozen as tfidf_loaded="
                         f"{tfidf_loaded} asks; build the state with "
                         "make_train_state first, with the same tfidf_loaded")
    if cfg.optim_state_dtype not in _STATE_DTYPES:
        raise ValueError(f"unknown optim_state_dtype {cfg.optim_state_dtype!r}")
    state_dtype = _STATE_DTYPES[cfg.optim_state_dtype]
    require_f32_math()
    n_ans = model.cfg.num_ans_candidates
    score_fn = compute_score_mc if mc_scoring else compute_score_with_logits
    # JAX distils BAN and SAN only (steps.py:208)
    distill = cfg.distillation and mcfg.model in ("ban", "san")
    dp = 1 if mesh is None else mesh.dp
    data = None if mesh is None else mesh.data
    model_group = None if mesh is None else mesh.model

    def apply_update(state: TrainState, grads, lr, count: int) -> torch.Tensor:
        grads = reduce_grads(grads, data)
        if count > 1:
            grads = torch._foreach_div(grads, float(count))
        grads, norm = clip_flat_grads(
            grads, cfg.clip_norm, split_flags(state.optimizer.params),
            model_group)
        state.optimizer.step(grads, lr)
        state.step += 1
        return norm

    def step(state: TrainState, batch: dict, lr: Union[float, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             force_update: bool = False) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than the step's")
        if state.optimizer.state_dtype != state_dtype:
            raise ValueError(
                f"optim_state_dtype={cfg.optim_state_dtype!r}, but the state's "
                f"Adamax stores {state.optimizer.state_dtype or 'float32'}; "
                "build it with make_train_state(optim_state_dtype="
                f"{cfg.optim_state_dtype!r})")
        check_f32_math("training step")
        if not model.training:
            model.train()
        params = state.optimizer.params
        dev = params[0].device
        if not all(torch.is_tensor(x) and x.device == dev
                   for x in batch.values()):
            batch = wire_cast(batch, cfg.transfer_dtype)
        batch = upcast_wire(_on_device(batch, dev))
        batch = densify_target(batch, n_ans)
        ctx = (ctx_factory() if ctx_factory is not None else
               Ctx(train=not cfg.deterministic, generator=generator,
                   mask_bits=cfg.mask_bits))
        logits = forward_in(model, half, batch, ctx)
        target = batch["target"].float()
        if distill:
            loss = distillation_loss(logits, batch["t_logits"].float(), target,
                                     cfg.T, cfg.alpha)
        else:
            loss = bce_with_logits_sum(logits, target) / logits.shape[0]
        if dp > 1:
            loss = loss / dp  # this rank's share of the global batch's loss
        grads = list(torch.autograd.grad(loss, params))
        loss = loss.detach()
        if data is not None:
            loss = data.all_reduce(loss.clone())
        finite = torch.isfinite(loss)
        if cfg.skip_nonfinite:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.where(finite, g, zero) for g in grads]

        if cfg.update_freq == 1:
            count = 1
            grad_norm = apply_update(state, grads, lr, 1)
        else:
            if state.grad_accum is None:
                state.grad_accum = grads
            else:
                torch._foreach_add_(state.grad_accum, grads)
            state.accum_count += 1
            count = state.accum_count
            if force_update or count >= cfg.update_freq:
                grad_norm = apply_update(state, state.grad_accum, lr, count)
                state.grad_accum, state.accum_count = None, 0
            else:
                grad_norm = torch.zeros((), dtype=torch.float32, device=dev)
        updated = int(force_update or count >= cfg.update_freq)
        score = score_fn(logits.detach(), target)
        if data is not None:
            score = data.all_reduce(score.clone())
        return {
            "loss": loss,
            "grad_norm": grad_norm,
            "batch_score": score,
            "updated": torch.full((), updated, dtype=torch.int32, device=dev),
            "skipped": ((~finite) & cfg.skip_nonfinite).to(torch.int32),
        }

    return step


def make_eval_step(model: nn.Module, mc_scoring: bool = False,
                   compute_dtype: str = "float32"):
    """Eval (``steps.py:321-353``): ``eval_step(batch)`` -> float32
    ``logits`` and, where the batch has a ``target``, the soft ``score``
    and its ``upper_bound``, as tensors on the model's device (with
    ``mc_scoring`` the group accuracy :func:`compute_score_mc` of the
    ``x4``-expanded rows, and no bound).  Zero-padded rows add 0 to both.
    A wire-cast batch (:func:`wire_cast`) is upcast on the card;
    ``compute_dtype="bfloat16"`` casts the parameters and ``v`` for the
    forward."""
    half = _check_compute_dtype(compute_dtype)
    require_f32_math()

    def eval_step(batch: dict) -> Dict[str, torch.Tensor]:
        check_f32_math("eval step")
        dev = next(model.parameters()).device
        with torch.inference_mode():
            b = upcast_wire(_on_device(batch, dev))
            logits = forward_in(model, half, b)
            out = {"logits": logits}
            if "target" in b:
                target = b["target"].float()
                if mc_scoring:
                    out["score"] = compute_score_mc(logits, target)
                else:
                    out["score"] = compute_score_with_logits(logits, target)
                    out["upper_bound"] = target.max(dim=1).values.sum()
        return out

    return eval_step
