"""The epoch loop of the FFOE and MC pipelines (``vqatpu/train/loop.py:
204-482``, reference ``FFOE/train.py:24-116`` and ``MC/train.py:22-120``).

The LR of each epoch comes from the host (:func:`~vqatpu_torch.train.optim.
lr_for_epoch`), with the reference's log lines; accumulation, the clip and
Adamax live in the step (:mod:`vqatpu_torch.train.steps`).  Each epoch ends
with an eval on ``make_eval_loader(eval_ds, 2 * batch_size)`` and, from
``saving_epoch`` on, ``model_epoch{E}.ckpt`` plus ``model_epoch_best.ckpt``
when the eval score beats ``best_eval``, which rides in the checkpoint's
``extra`` so that a resumed run cannot overwrite a better best checkpoint
(``ckpt_backend="orbax"``: ``.orbax`` directories, below).
``log.txt`` has JAX's lines.

With ``task="mc"`` (Visual7W) each batch of questions, for training and
for the eval, is expanded ``x4`` on the host into candidate rows with
2-class targets (:func:`~vqatpu_torch.data.mc_dataset.expand_mc_batch`;
the store's wire repeats ``ds_idx``, and the gather gives the expanded
slabs), the step scores groups of 4 (``mc_scoring``), the train score is
counted over ``num_updates x batch_size`` questions and the eval is
:func:`~vqatpu_torch.eval.mc.evaluate_mc`.

The step's metrics stay on the card: each update adds its loss, pre-clip
grad norm and batch score to running sums there, read back only every
``print_interval`` updates and at the end of the epoch.

Where batches come from (JAX's rules and log lines, ``loop.py:47-160``):

- ``cfg.device_features`` (``auto`` by default, ``on``, ``off``) decides,
  after the train state is on the device, whether the training set's
  features go to the card (:class:`~vqatpu_torch.data.device_store.
  DeviceFeatureStore`); then the loader ships the fields and ``ds_idx``
  only (the Python ``BatchLoader(fields_only=True)``, sparse targets with
  ``cfg.sparse_targets``) and each step gathers its boxes on the card.
  The in-loop eval builds its own store once, on the first eval epoch.
- Else ``use_native_loader`` gives the C++ ``NativeBatchLoader`` (page-
  locked ring buffers where CUDA is available; quantized on assembly on
  the int8 wire) where the dataset has an in-memory store, and the Python
  ``BatchLoader`` on a prefetch thread otherwise, with the reason in the
  log.  Both are shuffled by a ``RandomState(cfg.seed)`` drawn once an
  epoch and yield the same batches.
- Host batches go to the card through a
  :class:`~vqatpu_torch.data.upload.PinnedUploader`: page-locked, double
  buffered, the upload of batch n+1 beside step n.

``profile_dir`` traces steps 1 to ``min(6, n_batches - 1)`` of the first
epoch (JAX's window, ``vqatpu/train/loop.py:377-385``) with
``torch.profiler`` (:mod:`vqatpu_torch.train.profiling`), each step a
``train_step`` range around its ``.forward``, ``.backward`` and
``.optimizer`` ranges, the card synchronized before the trace stops.

Several devices (``vqatpu/train/loop.py:232-271``): one process a device,
joined by :func:`vqatpu_torch.parallel.distributed.init_distributed`
before the call.  Every process runs the same seeded loader over the whole
set and takes its data index's rows of each batch; the step sums the
gradients over the data axis (:func:`~vqatpu_torch.train.steps.
make_train_step`).  ``tp > 1`` trains on a ``dp x tp`` mesh with the
model split by :func:`~vqatpu_torch.parallel.sharding.shard_model`
(``fused_v_tucker`` refused, as JAX refuses it).
Every process starts from rank 0's state (broadcast).  Only rank 0 writes
``log.txt`` and checkpoints; under ``tp`` the model group gathers the
whole state first, so the file is the single-device one.  The eval is
split over the data axis where the eval batch divides it (each rank scores
its rows, the sums are added over the axis).  Dropout draws from a
generator seeded by ``(seed, data index)``, shared by a model group: its
masks equal JAX's global-key masks in distribution, not bit for bit (with
one data index, the single process's ``seed``).  Each process can put its
features on its card: the replicated store, or with
``shard_feature_store`` the row-sharded one, each rank owning a share of
the rows (:class:`~vqatpu_torch.data.device_store.DeviceFeatureStore`).

``ckpt_backend="orbax"`` writes ``model_epoch{E}.orbax`` and
``model_epoch_best.orbax`` in place of the ``.ckpt`` files, JAX's orbax
directories (:func:`~vqatpu_torch.train.checkpoints.save_checkpoint_orbax`,
no ``extra``, as in JAX), removing an existing best slot first, since
orbax does not overwrite (``vqatpu/train/loop.py:462-493``).  An
out-of-memory error of the card (``torch.cuda.OutOfMemoryError``) skips
its batch, drops the accumulation window and is counted (the reference's
policy, ``FFOE/trainer.py:206-219``); a step that fails that way may have
left its update half applied, where JAX's functional state is untouched.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from vqatpu_torch.config import TrainConfig
from vqatpu_torch.data.batching import (BatchLoader, PrefetchLoader,
                                        make_eval_loader, max_target_labels)
from vqatpu_torch.data.device_store import (DeviceFeatureStore,
                                            devstore_capable,
                                            devstore_decision,
                                            normalize_device_features)
from vqatpu_torch.data.mc_dataset import expand_mc_batch
from vqatpu_torch.data.upload import PinnedUploader
from vqatpu_torch.eval.ffoe import evaluate as evaluate_ffoe
from vqatpu_torch.eval.mc import evaluate_mc
from vqatpu_torch.parallel.distributed import process_count
from vqatpu_torch.parallel.sharding import (make_mesh, make_mesh_2d,
                                            replicate, shard_batch,
                                            shard_leaf, shard_model)
from vqatpu_torch.train.checkpoints import (save_checkpoint,
                                           save_checkpoint_orbax)
from vqatpu_torch.train.logging import Logger, time_since
from vqatpu_torch.train.optim import lr_for_epoch
from vqatpu_torch.train.profiling import start_trace, stop_trace
from vqatpu_torch.train.steps import (TrainState, make_train_state,
                                      make_train_step, wire_cast)

_FFOE_KEYS = ("v", "v_scale", "b", "q", "a", "v_mask", "target",
              "t_label", "t_score", "t_logits")
_SUM_KEYS = ("loss", "grad_norm", "batch_score")
_UNSET = object()


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _make_loader(dataset, cfg: TrainConfig, use_native: bool, logger=None,
                 dev_store=None, task: str = "ffoe"):
    """The shuffled training loader (``vqatpu/train/loop.py:59-92``): with a
    card-resident store, the Python fields-only loader; else the C++
    ``NativeBatchLoader`` where asked for and the dataset can take it (with
    ``transfer_dtype="int8"`` it quantizes on assembly, and ``wire_cast``
    passes the quantized ``v`` through), else the Python loader on a
    prefetch thread, the reason in the log.  Sparse targets are free-form
    only: MC builds its targets from the labels at the expansion."""
    if dev_store is not None:
        k = (max_target_labels(dataset)
             if cfg.sparse_targets and task == "ffoe" else 0)
        return PrefetchLoader(BatchLoader(
            dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
            drop_last=True, fields_only=True, sparse_target_k=k))
    if use_native and devstore_capable(dataset)[0]:
        from vqatpu_torch.data.native import NativeBatchLoader

        return NativeBatchLoader(
            dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
            drop_last=True, quantize=(cfg.transfer_dtype == "int8"))
    if use_native and logger is not None:
        logger.write("native loader OFF (dataset has no in-memory "
                     "FeatureStore (streaming or MC)); using Python loader")
    return PrefetchLoader(
        BatchLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                    drop_last=True))


def _make_device_store(dataset, cfg: TrainConfig, logger, device,
                       what: str = "", task: str = "ffoe", mesh=None):
    """The card-resident store per ``cfg.device_features``
    (``vqatpu/train/loop.py:115-160``); a decline is logged with its
    reason, except under ``off``.  ``shard_feature_store`` implies ``on``
    and row-shards the tables over the mesh's data axis."""
    mode = normalize_device_features(cfg.device_features)
    shard = cfg.shard_feature_store
    if shard:
        mode = "on"
    if mode == "off":
        return None
    build, why = devstore_decision(dataset, mode, cfg.transfer_dtype,
                                   task=task, shard=shard, device=device)
    if not build:
        tag = "auto-OFF" if mode == "auto" else "OFF"
        logger.write(f"{what}device feature store {tag} ({why}); "
                     "using host wire")
        return None
    store = DeviceFeatureStore.build(
        dataset, transfer_dtype=cfg.transfer_dtype, device=device,
        shard=shard, mesh=mesh)
    logger.write(f"{what}device feature store: {store.describe()}")
    return store


def _make_eval_device_store(eval_ds, cfg: TrainConfig, logger, device,
                            task: str, mesh):
    """The eval's store (``vqatpu/train/loop.py:95-112``): declined where the
    (2x) eval batch does not divide the data axis, since the store's gather
    takes a rank's rows."""
    dp = 1 if mesh is None else mesh.dp
    if (cfg.batch_size * 2) % dp != 0:
        logger.write("eval device feature store OFF (eval batch %d not "
                     "divisible by the data mesh %d); using host wire"
                     % (cfg.batch_size * 2, dp))
        return None
    return _make_device_store(eval_ds, cfg, logger, device, what="eval ",
                              task=task, mesh=mesh)


def _refuse_unported(cfg: TrainConfig, task: str) -> None:
    if task not in ("ffoe", "mc"):
        raise ValueError(f"unknown task {task!r}; expected ffoe or mc")
    if cfg.ckpt_backend not in ("pickle", "orbax"):
        raise ValueError(f"unknown ckpt_backend {cfg.ckpt_backend!r}; "
                         "expected pickle or orbax")
    normalize_device_features(cfg.device_features)  # raises if unknown


def _make_mesh(model, use_mesh: bool, num_devices: Optional[int], tp: int):
    """JAX's mesh choice (``vqatpu/train/loop.py:250-271``) over the
    processes: None for one process without ``tp``."""
    world = process_count()
    if not use_mesh:
        if tp > 1:
            raise ValueError("tp > 1 needs the mesh (drop --no_mesh)")
        return None
    if tp > 1:
        if model.cfg.fused_v_tucker:
            # the fused GEMM joins the replicated t_att tucker with the
            # d-split t_net tuckers (JAX's assert, loop.py:260-263)
            raise ValueError("fused_v_tucker is incompatible with a model "
                             "(tp) axis")
        ndev = num_devices if num_devices is not None else world
        if ndev != world or ndev % tp:
            raise ValueError(f"tp={tp} on {ndev} devices: the port runs one "
                             f"process a device ({world} running), and tp "
                             "must divide them")
        return make_mesh_2d(ndev // tp, tp)
    if world > 1 or num_devices not in (None, 1):
        return make_mesh(num_devices)
    return None


def _check_pool_width(model, mesh, cfg: TrainConfig, device) -> None:
    """K2 takes the ``d / tp`` columns of a rank's ``t_net`` tuckers in
    16-byte copies: on CUDA ``d / tp`` must be a multiple of 4 at float32
    compute and of 8 at bf16."""
    net = getattr(model, "t_net0", None)
    if net is None or torch.device(device).type != "cuda":
        return
    d, unit = net.d, 8 if cfg.compute_dtype == "bfloat16" else 4
    if d % mesh.tp or (d // mesh.tp) % unit:
        raise ValueError(
            f"tp={mesh.tp}: K2 pools d / tp = {d} / {mesh.tp} columns a "
            f"rank, which must be a whole multiple of {unit} at "
            f"{cfg.compute_dtype} compute; choose tp with d % (tp * {unit}) "
            "== 0")


def put_on_mesh(state: TrainState, mesh, cfg: TrainConfig,
                logger=None) -> dict:
    """Every process takes rank 0's params and Adamax state; under ``tp``
    the model and its moments keep this rank's slices.  -> the layout
    (:func:`~vqatpu_torch.parallel.sharding.param_shardings`; all None at
    ``tp == 1``)."""
    opt = state.optimizer
    replicate([p.data for p in state.model.parameters()] + opt.m + opt.u,
              mesh)
    if mesh.tp == 1:
        return {n: None for n, _ in state.model.named_parameters()}
    _check_pool_width(state.model, mesh, cfg, opt.params[0].device)
    specs = shard_model(state.model, mesh)
    for i, p in enumerate(opt.params):
        dim = getattr(p, "_tp_dim", None)
        if dim is not None:
            opt.m[i] = shard_leaf(opt.m[i], dim, mesh)
            opt.u[i] = shard_leaf(opt.u[i], dim, mesh)
    state.grad_accum, state.accum_count = None, 0
    split = sorted(k for k, d in specs.items() if d is not None)
    if logger is not None:
        logger.write(f"mesh: data={mesh.dp} x model={mesh.tp}; split over "
                     f"the model axis: {split}")
    return specs


class _NullLogger:
    """Ranks other than 0 log nothing (one writer of log.txt)."""

    def write(self, *_args, **_kw):
        pass

    def close(self):
        pass


def _dropout_seed(cfg: TrainConfig, mesh) -> int:
    """``seed``, or with several data indices a seed of ``(seed, d)``."""
    if mesh is None or mesh.dp == 1:
        return cfg.seed
    return int(np.random.SeedSequence(
        [cfg.seed, mesh.coords[0]]).generate_state(1)[0])


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
    without it; over several processes (see the module docstring) it
    builds the mesh, ``num_devices`` (their number) and ``tp`` its
    shape."""
    _refuse_unported(cfg, task)
    mesh = _make_mesh(model, use_mesh, num_devices, tp)
    primary = mesh is None or mesh.primary
    os.makedirs(output, exist_ok=True)
    logger = (Logger(os.path.join(output, "log.txt")) if primary
              else _NullLogger())
    loaders = []  # the C++ loaders' worker threads end with the run
    try:
        return _train(model, train_ds, eval_ds, cfg, output, task, state,
                      start_epoch, tfidf_loaded, print_interval,
                      use_native_loader, best_eval, device, logger, loaders,
                      profile_dir, mesh)
    finally:
        for loader in loaders:
            if hasattr(loader, "close"):
                loader.close()
        logger.close()


def _train(model, train_ds, eval_ds, cfg, output, task, state, start_epoch,
           tfidf_loaded, print_interval, use_native_loader, best_eval,
           device, logger, loaders, profile_dir, mesh) -> TrainState:
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
    mc = task == "mc"
    if mesh is not None:
        put_on_mesh(state, mesh, cfg, logger)
    primary = mesh is None or mesh.primary
    split_rows = mesh is not None and mesh.dp > 1
    step_fn = make_train_step(model, cfg, tfidf_loaded, mc_scoring=mc,
                              mesh=mesh)
    dev = next(model.parameters()).device
    # decided after the state is on the device: the auto budget sees the
    # memory the model and the optimizer leave free
    dev_store = _make_device_store(train_ds, cfg, logger, dev, task=task,
                                   mesh=mesh)
    loader = _make_loader(train_ds, cfg, use_native_loader, logger=logger,
                          dev_store=dev_store, task=task)
    loaders.append(loader)
    eval_loader = None  # built on the first eval epoch, then reused
    # the eval's store, built at most once, where the training set's is
    eval_store = _UNSET if dev_store is not None else None
    upload = PinnedUploader(dev)
    gen = torch.Generator(device=dev).manual_seed(_dropout_seed(cfg, mesh))

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
        # the profiled window: steps 1 to min(6, n_batches - 1), first epoch
        prof_steps = (range(1, min(6, n_batches - 1) + 1)
                      if profile_dir and epoch == start_epoch else range(0))
        prof = None
        for i, batch in enumerate(loader):
            if mc:  # candidate rows, and their ds_idx for the store
                batch = expand_mc_batch(batch)
            if split_rows:  # this rank's rows of the global batch
                batch = shard_batch({k: batch[k] for k in _FFOE_KEYS + (
                    "ds_idx",) if k in batch}, mesh)
            db = upload(wire_cast({k: batch[k] for k in _FFOE_KEYS
                                   if k in batch}, cfg.transfer_dtype))
            if dev_store is not None:
                db.update(dev_store.gather(batch["ds_idx"]))
            del batch  # the native loader reuses buffers nothing refers to
            # the reference flushes accumulation on each epoch's last batch
            # (FFOE/train.py:78-82): windows never straddle epochs
            force = cfg.update_freq > 1 and (i == n_batches - 1)
            if i in prof_steps and prof is None:
                prof = start_trace(profile_dir)
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
            finally:
                if prof is not None and i + 1 not in prof_steps:
                    stop_trace(prof)
                    prof = None
                    logger.write(f"profile of steps {prof_steps.start}-{i} "
                                 f"written to {profile_dir}")
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
            if primary and did_update and num_updates % print_every == 0:
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
        # MC's batch score is per group of 4 candidates: per question
        train_score = 100.0 * train_score / max(num_updates * cfg.batch_size, 1)

        eval_score, bound = 0.0, 0.0
        if eval_ds is not None:
            # the reference evaluates with a 2x batch (FFOE/main.py:146)
            if eval_loader is None:
                if eval_store is _UNSET:
                    eval_store = _make_eval_device_store(
                        eval_ds, cfg, logger, dev, task, mesh)
                eval_loader = make_eval_loader(
                    eval_ds, cfg.batch_size * 2, use_native=use_native_loader,
                    quantize=(cfg.transfer_dtype == "int8"),
                    fields_only=eval_store is not None)
                loaders.append(eval_loader)
            evaluate = evaluate_mc if mc else evaluate_ffoe
            eval_score, bound = evaluate(
                model, eval_loader, compute_dtype=cfg.compute_dtype,
                transfer_dtype=cfg.transfer_dtype, dev_store=eval_store,
                mesh=mesh)

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
            _save_ckpt(output, f"model_epoch{epoch}", state, epoch, extra,
                       cfg.ckpt_backend, mesh)
            if new_best:
                _save_ckpt(output, "model_epoch_best", state, epoch, extra,
                           cfg.ckpt_backend, mesh)
    return state


def _save_ckpt(output: str, name: str, state: TrainState, epoch: int,
               extra: dict, backend: str, mesh=None) -> None:
    """Rank 0 writes; under ``tp`` every rank takes part in the gather."""
    primary = mesh is None or mesh.primary
    if not (primary or mesh.tp > 1):
        return
    if backend == "orbax":
        path = os.path.join(output, name + ".orbax")
        if primary and os.path.exists(path):  # the best slot
            shutil.rmtree(path)
        save_checkpoint_orbax(path, state, epoch, mesh=mesh, write=primary)
    else:
        save_checkpoint(os.path.join(output, name + ".ckpt"), state, epoch,
                        extra=extra, mesh=mesh, write=primary)
