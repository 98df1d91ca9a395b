"""The control on the card: the plain reference put in the program's place
and computed with TF32 (the nearest precision below the configurations'
float32) fails each cell's limits.  At the cells' widths and batches, on a
split cut to 4,096 questions over 400 images; the readings at the cells'
own size, on three seeds, are in ``PERF.md`` (``benchmark.calibrate``)."""

from __future__ import annotations

import pytest

from benchmark import compare
from benchmark.traffic import logits, train
from conftest import CELLS, SEED, tiny_cell


def _as_program(out: dict) -> dict:
    names = out["names"]
    return {"losses": out["losses"].numpy(),
            "grad": dict(zip(names, out["grad"].tolist())),
            "change": dict(zip(names, out["change"].tolist()))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_limits(cuda, tmp_path, name):
    cell = tiny_cell(tmp_path, name, tiny=False)
    if cell.workload["kind"] == "train":
        sess = train.Session(cell, SEED, "cuda")
        sess.close()
        ref = sess.reference()
        readings = compare.train_readings(_as_program(sess.reference("tf32")),
                                          ref, sess.uf)
    else:
        sess = logits.Session(cell, SEED, "cuda")
        sess.stride, sess.phase = 1, 0
        sess.window(1.0)
        sess.close()
        ref = sess.reference()
        readings = sess.readings(sess.reference("tf32"))
        assert sess.readings(ref)["logit_gap"] == 0.0
    ok, checks = compare.judge(readings, cell.workload["limits"])
    assert not ok, checks
