"""Training from the card-resident store, fed as the program's epoch loop
(``vqatpu_torch/train/loop.py``) feeds its step: the loader's shuffled
batches of fields on a prefetch thread, multiple-choice batches expanded
to candidate rows on the host, the fields through the page-locked
uploader, the boxes gathered on the card by the store, then the step of
``make_train_step`` with the epoch's learning rate and the dropout
generator; at each update the step's metrics are added on the card.

Set-up builds the model from the seed's weights, its optimizer and the
store, and drives the first ``check_updates`` updates through the same
call and feed.  Their losses, the first update's gradient (from Adamax's
first moment) and the weights' change after them are what
:meth:`Session.check` holds to the plain reference, which follows the
same microbatches with the same dropout masks.  The window starts after
them and runs whole updates until ``--seconds`` have passed; it ends with
a readback of the metric sums, after the card has finished every step.

The workload file's keys (besides those of ``benchmark.gen`` and
``benchmark.store``): ``batch`` (questions a microbatch), ``lr_epoch``
(the schedule's epoch whose rate the window runs at), ``check_updates``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import compare, core, gen, spans, store, weights
from benchmark.reference import features
from benchmark.reference import train as ref_train
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data.batching import PrefetchLoader
from vqatpu_torch.data.device_store import DeviceFeatureStore
from vqatpu_torch.data.mc_dataset import expand_mc_batch
from vqatpu_torch.data.upload import PinnedUploader
from vqatpu_torch.train.steps import (make_train_state, make_train_step,
                                      wire_cast)

FIELD_KEYS = ("q", "a", "target")  # what the loop uploads of a store batch
SUM_KEYS = ("loss", "grad_norm", "batch_score")


def build_model(cell, w: dict, device, laps=None):
    """The program's model of ``cell`` with the weights ``w``, allocated on
    ``device`` without an initialisation of its own."""
    mcls = core.program_class(cell.config["program_model"])
    with torch.device("meta"):
        model = mcls(ModelConfig(**cell.model))
    model = model.to_empty(device=device)
    if laps:
        laps("model on the device")
    model.load_state_dict(w, strict=True)
    return model


def make_store(table: dict) -> DeviceFeatureStore:
    return DeviceFeatureStore(table["feats"], table["scales"], table["spats"],
                              table["rows_table"], table["sample_img"],
                              table["sentinel"])


def shape_of(cell) -> dict:
    m, sh, wl = cell.model, cell.config["shapes"], cell.workload
    rows = wl["batch"] * wl.get("candidates", 1)
    return {"B": rows, "V": wl["max_boxes"], "Q": sh["question_len"],
            "A": sh["answer_len"], "G": m["gamma"], "R": m["rank"],
            "X": m["h_mm"] // m["rank"], "D": 2 * m["h_mm"]}


class Session:
    train = True

    def __init__(self, cell, seed: int, device, laps=None):
        lap = laps or (lambda stage: None)
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        m, wl, tr = cell.model, cell.workload, cell.config["train"]
        self.shape = shape_of(cell)
        self.flop_per_sample = cell.arch.model_flop(
            m, wl["max_boxes"], self.shape["Q"], self.shape["A"], train=True)
        self.mc = "candidates" in wl
        self.lr = core.lr_at(tr, wl["lr_epoch"])
        self.uf = tr["update_freq"]
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        self.tcfg = TrainConfig(**{k: v for k, v in tr.items() if k in fields})

        w = weights.make(cell.arch.leaves(m), gen.derive(seed, gen.WEIGHTS),
                         self.device)
        lap("weights")
        self.model = build_model(cell, w, self.device, laps)
        self.state = make_train_state(
            self.model, tfidf_loaded=cell.config["tfidf"],
            optim_state_dtype=self.tcfg.optim_state_dtype, device=self.device)
        self.step = make_train_step(self.model, self.tcfg,
                                    tfidf_loaded=cell.config["tfidf"],
                                    mc_scoring=self.mc)
        lap("weights loaded, optimizer and step")
        self.store = make_store(store.make(wl, m["v_dim"], seed, self.device))
        lap("store")
        self.stream = gen.Stream(gen.fields(m, cell.config["shapes"], wl, seed),
                                 m["num_ans_candidates"], wl["batch"], seed,
                                 shuffle=True)
        self.it = iter(PrefetchLoader(self.stream))
        self.upload = PinnedUploader(self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            gen.derive(seed, gen.DROPOUT))
        lap("fields")
        self.prog = self._check_steps(w)
        del w
        lap("check steps")

    def _feed(self, batch: dict, sp=None, marks=None) -> dict:
        with spans.label(marks, "upload"):
            if self.mc:  # candidate rows, and their ds_idx for the store
                batch = expand_mc_batch(batch)
            e0 = sp.mark() if sp else None
            db = self.upload(wire_cast({k: batch[k] for k in FIELD_KEYS},
                                       self.tcfg.transfer_dtype))
        with spans.label(marks, "gather"):
            db.update(self.store.gather(batch["ds_idx"]))
        if sp:
            sp.pair("gather", e0, sp.mark())
        return db

    def _one(self, sp=None, marks=None):
        """One microbatch through the loop's feed and the step."""
        with spans.label(marks, "batch"):
            batch = next(self.it)
        if sp is None:
            db = self._feed(batch, marks=marks)
            with spans.label(marks, "step"):
                return self.step(self.state, db, self.lr, self.gen)
        with sp.host_span("feed"):
            db = self._feed(batch, sp, marks)
        e1 = sp.mark()
        with sp.host_span("call"), spans.label(marks, "step"):
            metrics = self.step(self.state, db, self.lr, self.gen)
        sp.pair("call", e1, sp.mark())
        return metrics

    def _check_steps(self, w: dict) -> dict:
        """The first ``check_updates`` updates; -> what they read."""
        opt = self.state.optimizer
        names = {id(p): n for n, p in self.model.named_parameters()}
        leaves = [names[id(p)] for p in opt.params]
        losses, grad = [], None
        for i in range(self.cell.workload["check_updates"] * self.uf):
            losses.append(self._one()["loss"])
            if i == self.uf - 1:
                grad = torch.stack([x.double().norm() for x in opt.m]) \
                    / (1.0 - opt.b1)
        with torch.no_grad():
            change = torch.stack([(p - w[n]).double().norm()
                                  for p, n in zip(opt.params, leaves)])
        return {"losses": torch.stack(losses).double().cpu().numpy(),
                "grad": dict(zip(leaves, grad.cpu().tolist())),
                "change": dict(zip(leaves, change.cpu().tolist()))}

    def window(self, seconds: float, sp=None, marks=None) -> dict:
        """Whole updates until ``seconds`` have passed; ``sp`` records each
        call's spans, ``marks`` marks them for the profiler."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        sums, n = None, 0
        t0 = time.perf_counter()
        while True:
            for _ in range(self.uf):
                metrics = self._one(sp, marks)
                n += 1
            # the loop's running sums, added at each update
            if sums is None:
                sums = {k: metrics[k].clone() for k in SUM_KEYS}
            else:
                for k in SUM_KEYS:
                    sums[k] += metrics[k]
            if time.perf_counter() - t0 >= seconds:
                break
        finite = all(np.isfinite(float(sums[k])) for k in SUM_KEYS)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter() - t0
        samples = n * self.cell.workload["batch"]
        return {"seconds": t, "samples": samples, "steps": n,
                "failed": 0 if finite else samples}

    def close(self) -> None:
        """Stop the loader and free the program's state and store."""
        self.stream.stop()
        gen.drain(self.it)
        del self.it, self.model, self.state, self.step, self.store
        del self.upload
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", rows_cut=None,
                  alter=None) -> dict:
        """The plain reference over the check's microbatches, from the
        seed's weights, table, batches and dropout stream; ``precision``
        ``tf32`` lets cuBLAS round the operands to TF32 (the control).
        ``rows_cut`` keeps that many rows of each microbatch and ``alter``
        changes the logits (planted faults)."""
        cell, seed, dev = self.cell, self.seed, self.device
        m, wl, tr = cell.model, cell.workload, cell.config["train"]
        tf32 = precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            w0 = weights.make(cell.arch.leaves(m),
                              gen.derive(seed, gen.WEIGHTS), dev)
            table = store.make(wl, m["v_dim"], seed, dev)
            stream = gen.Stream(gen.fields(m, cell.config["shapes"], wl, seed),
                                m["num_ans_candidates"], wl["batch"], seed,
                                shuffle=True)
            n = wl["check_updates"] * self.uf
            rows = (_rows(table, gen.expand(b), dev, rows_cut)
                    for b in gen.first(stream, n))
            drop = torch.Generator(device=dev).manual_seed(
                gen.derive(seed, gen.DROPOUT))
            return ref_train.train(cell.arch, w0, m, self.uf, tr["clip_norm"],
                                   self.lr, rows, drop, wl["check_updates"],
                                   alter)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def check(self):
        """-> (the compared numbers, failed samples)."""
        return compare.train_readings(self.prog, self.reference(),
                                      self.uf), 0


def _rows(table: dict, r: dict, dev, cut=None) -> dict:
    n = len(r["ds_idx"]) if cut is None else cut
    v, v_mask = features.gather(table, r["ds_idx"][:n])
    return {"v": v, "v_mask": v_mask,
            "q": torch.as_tensor(r["q"][:n], device=dev).long(),
            "a": torch.as_tensor(r["a"][:n], device=dev).long(),
            "target": torch.as_tensor(r["target"][:n], device=dev)}
