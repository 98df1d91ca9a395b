"""The epoch loop of the FFOE pipeline (``vqatpu/train/loop.py:204-482``,
reference ``FFOE/train.py:24-116``).

The LR of each epoch comes from the host (:func:`~vqatpu_torch.train.optim.
lr_for_epoch`), with the reference's log lines; accumulation, the clip and
Adamax live in the step (:mod:`vqatpu_torch.train.steps`).  Each epoch ends
with an eval on ``make_eval_loader(eval_ds, 2 * batch_size)`` and, from
``saving_epoch`` on, ``model_epoch{E}.ckpt`` plus ``model_epoch_best.ckpt``
when the eval score beats ``best_eval``, which rides in the checkpoint's
``extra`` so that a resumed run cannot overwrite a better best checkpoint.
``log.txt`` has JAX's lines.

The step's metrics stay on the card: each update adds its loss, pre-clip
grad norm and batch score to running sums there, read back only every
``print_interval`` updates and at the end of the epoch.  Batches come from
the Python ``BatchLoader`` on a prefetch thread (shuffled by its own
``RandomState(cfg.seed)``, drawn once an epoch), as JAX's fallback loader.

Not ported, and so refused or logged rather than ignored: the native C++
loader (ROADMAP queue A item 4b; ``use_native_loader`` logs that it is
off, as JAX does when its library is missing), the training card-resident
feature store (item 4e; ``device_features="auto"`` logs that it builds none,
``"on"`` and ``shard_feature_store`` raise), meshes over several devices,
``tp > 1``, several processes and orbax checkpoints (item 9), and
``profile_dir`` (item 10).  An out-of-memory error of the card
(``torch.cuda.OutOfMemoryError``) skips its batch, drops the accumulation
window and is counted (the reference's policy, ``FFOE/trainer.py:206-219``);
a step that fails that way may have left its update half applied, where
JAX's functional state is untouched.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from vqatpu_torch.config import TrainConfig
from vqatpu_torch.data.batching import (BatchLoader, PrefetchLoader,
                                        make_eval_loader)
from vqatpu_torch.eval.ffoe import evaluate as evaluate_ffoe
from vqatpu_torch.train.checkpoints import save_checkpoint
from vqatpu_torch.train.logging import Logger, time_since
from vqatpu_torch.train.optim import lr_for_epoch
from vqatpu_torch.train.steps import (TrainState, make_train_state,
                                      make_train_step)

_FFOE_KEYS = ("v", "v_scale", "b", "q", "a", "v_mask", "target",
              "t_label", "t_score", "t_logits")
_SUM_KEYS = ("loss", "grad_norm", "batch_score")


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _make_loader(dataset, cfg: TrainConfig, use_native: bool, logger=None):
    """The shuffled training loader: the Python ``BatchLoader`` on a
    prefetch thread.  JAX prefers its native C++ loader, which yields the
    same batches; asked for it, this says that it is off and why."""
    if use_native and logger is not None:
        logger.write("native loader OFF (not ported: ROADMAP queue A item "
                     "4b); using Python loader")
    return PrefetchLoader(
        BatchLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                    drop_last=True))


def _refuse_unported(cfg: TrainConfig, task: str, use_mesh: bool,
                     num_devices: Optional[int], tp: int,
                     profile_dir: Optional[str]) -> None:
    if task != "ffoe":
        raise NotImplementedError(
            f"task {task!r} is not ported (ROADMAP queue A item 7)")
    if cfg.ckpt_backend != "pickle":
        raise NotImplementedError(
            f"ckpt_backend={cfg.ckpt_backend!r} is not ported (ROADMAP queue "
            "A item 9)")
    if tp > 1 or (use_mesh and num_devices not in (None, 1)):
        raise NotImplementedError(
            "training on several devices (a data mesh or tp > 1) is not "
            "ported (ROADMAP queue A item 9)")
    if profile_dir:
        raise NotImplementedError(
            "profile_dir is not ported (ROADMAP queue A item 10)")
    if cfg.device_features not in ("auto", "on", "off"):
        raise ValueError(f"unknown device_features {cfg.device_features!r}")
    if cfg.device_features == "on" or cfg.shard_feature_store:
        raise NotImplementedError(
            "the training device feature store is not ported (ROADMAP queue "
            "A item 4e)")


def train(model, train_ds, eval_ds, cfg: TrainConfig, output: str,
          task: str = "ffoe", state: Optional[TrainState] = None,
          start_epoch: int = 0, tfidf_loaded: bool = False,
          use_mesh: bool = True, print_interval: int = 200,
          use_native_loader: bool = True,
          profile_dir: Optional[str] = None,
          num_devices: Optional[int] = None,
          tp: int = 1, best_eval: float = 0.0,
          device="cuda") -> TrainState:
    """Run the training schedule from ``start_epoch``; returns the final
    state.  ``state`` (from :func:`make_train_state` or a restored
    checkpoint) holds ``model``; without one, fresh weights are drawn from
    ``cfg.seed`` (:func:`vqatpu_torch.weights.numpy_params`) on
    ``device``.  ``best_eval``: the best eval score so far, from the
    checkpoint being resumed, so that a resumed run cannot overwrite a
    better ``model_epoch_best``.  ``use_mesh`` on one device trains as
    without it."""
    _refuse_unported(cfg, task, use_mesh, num_devices, tp, profile_dir)
    os.makedirs(output, exist_ok=True)
    logger = Logger(os.path.join(output, "log.txt"))
    try:
        return _train(model, train_ds, eval_ds, cfg, output, state,
                      start_epoch, tfidf_loaded, print_interval,
                      use_native_loader, best_eval, device, logger)
    finally:
        logger.close()


def _train(model, train_ds, eval_ds, cfg, output, state, start_epoch,
           tfidf_loaded, print_interval, use_native_loader, best_eval,
           device, logger) -> TrainState:
    logger.write(f"config: {cfg}")
    if state is None:
        state = make_train_state(model, seed=cfg.seed,
                                 tfidf_loaded=tfidf_loaded,
                                 optim_state_dtype=cfg.optim_state_dtype,
                                 device=device)
    elif state.model is not model:
        raise ValueError("the state holds another model than train()'s")
    logger.write(f"nParams=\t{count_params(model)}")
    logger.write(
        "optim: adamax lr=%.4f, decay_step=%d, decay_rate=%.2f, grad_clip=%.2f"
        % (cfg.lr, cfg.lr_decay_step, cfg.lr_decay_rate, cfg.clip_norm)
    )
    step_fn = make_train_step(model, cfg, tfidf_loaded)
    if cfg.device_features == "auto":
        logger.write("device feature store auto-OFF (not ported: ROADMAP "
                     "queue A item 4e); using host wire")
    loader = _make_loader(train_ds, cfg, use_native_loader, logger=logger)
    eval_loader = None  # built on the first eval epoch, then reused
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    wall_start = time.time()
    for epoch in range(start_epoch, cfg.epochs):
        lr = lr_for_epoch(cfg, epoch)
        if epoch < len(cfg.warmup_factors):
            logger.write("gradual warmup lr: %.8f" % lr)
        elif epoch in range(cfg.lr_decay_start, cfg.lr_decay_end,
                            cfg.lr_decay_step):
            logger.write("decreased lr: %.8f" % lr)
        else:
            logger.write("lr: %.8f" % lr)

        t0 = time.time()
        num_oom = 0
        metric_sums = None  # on the card, no readback per update
        num_updates = 0
        print_every = max(1, print_interval // cfg.update_freq)
        n_batches = len(loader)
        micro_count = 0  # the step's accumulation count, known on the host
        for i, batch in enumerate(loader):
            db = {k: batch[k] for k in _FFOE_KEYS if k in batch}
            # the reference flushes accumulation on each epoch's last batch
            # (FFOE/train.py:78-82): windows never straddle epochs
            force = cfg.update_freq > 1 and (i == n_batches - 1)
            try:
                metrics = step_fn(state, db, lr, gen, force)
            except torch.cuda.OutOfMemoryError:
                num_oom += 1
                logger.write(f"| WARNING: out of memory, skipping batch {i}")
                if cfg.update_freq > 1:
                    # the reference zero-grads (trainer.py:217): the window
                    # of buffered microbatches is dropped
                    state.grad_accum, state.accum_count = None, 0
                    micro_count = 0
                continue
            micro_count += 1
            did_update = force or micro_count >= cfg.update_freq
            if did_update:
                num_updates += 1
                micro_count = 0
                if metric_sums is None:
                    metric_sums = {k: metrics[k].clone() for k in _SUM_KEYS}
                else:
                    for k in _SUM_KEYS:
                        metric_sums[k] += metrics[k]
            if did_update and num_updates % print_every == 0:
                running = float(metric_sums["loss"])
                # / (num_updates + 1): the reference's own in-loop print
                # (FFOE/train.py:89-90); the epoch line divides by
                # num_updates (:94)
                print("Iter: {}, Loss {:.4f}, Norm: {:.4f}, Num updates: {},"
                      " Wall time: {:.2f}, ETA: {}".format(
                          i + 1, running / (num_updates + 1),
                          float(metrics["grad_norm"]), num_updates,
                          time.time() - wall_start,
                          time_since(t0, i / max(n_batches, 1))))

        if metric_sums is not None:
            total_loss = float(metric_sums["loss"]) / num_updates
            total_norm = float(metric_sums["grad_norm"])
            train_score = float(metric_sums["batch_score"])
        else:
            total_loss = total_norm = train_score = 0.0
        train_score = 100.0 * train_score / max(num_updates * cfg.batch_size, 1)

        eval_score, bound = 0.0, 0.0
        if eval_ds is not None:
            # the reference evaluates with a 2x batch (FFOE/main.py:146)
            if eval_loader is None:
                eval_loader = make_eval_loader(eval_ds, cfg.batch_size * 2)
            eval_score, bound = evaluate_ffoe(
                model, eval_loader, compute_dtype=cfg.compute_dtype,
                transfer_dtype=cfg.transfer_dtype)

        logger.write("epoch %d, time: %.2f" % (epoch, time.time() - t0))
        logger.write("\ttrain_loss: %.2f, norm: %.4f, score: %.2f"
                     % (total_loss, total_norm / max(num_updates, 1),
                        train_score))
        if num_oom:
            logger.write("\tskipped %d batches (OOM)" % num_oom)
        if eval_ds is not None:
            logger.write("\teval score: %.2f (%.2f)"
                         % (100 * eval_score, 100 * bound))

        if epoch >= cfg.saving_epoch:
            new_best = eval_ds is not None and eval_score > best_eval
            if new_best:
                best_eval = eval_score
            extra = {"model": model.cfg.model, "best_eval": best_eval}
            _save_ckpt(output, f"model_epoch{epoch}", state, epoch, extra)
            if new_best:
                _save_ckpt(output, "model_epoch_best", state, epoch, extra)
    return state


def _save_ckpt(output: str, name: str, state: TrainState, epoch: int,
               extra: dict) -> None:
    save_checkpoint(os.path.join(output, name + ".ckpt"), state, epoch,
                    extra=extra)
