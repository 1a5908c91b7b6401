"""The check refuses the control and the faults: the reference computed in
fp8 in the program's place, and a run whose timed path is broken
underneath (a state left unchanged, half the batch left out, from the
start or only once set-up is done, an answer altered), at the tiny size
on the CPU. The same control and faults read
at the cells' own sizes on the card: `python3 -m cellbench.calibrate`."""

import numpy as np
import pytest
import torch

from cellbench import calibrate, harness


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve", "tinyjoin.train",
                                  "tinyjoin.serve"])
def test_control_and_faults_fail_the_limits(root, cell):
    c = harness.Cell(root, cell)
    for seed in (11, 12, 13):
        for run, numbers in calibrate.controls(c, seed, torch.device("cpu")).items():
            if run == "bf16":  # the witness of rounding alone, not a fault
                continue
            over = [k for k, v in numbers.items() if k in c.limits and v > c.limits[k]]
            assert over, f"{run} on seed {seed} passes every limit: {numbers}"


def _unchanged(make):
    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def same(state, batch):
            keep = {t: {n: {k: v.detach().clone() for k, v in p.items()}
                        for n, p in state[t].items()} for t in ("params", "moms")}
            m = step(state, batch)
            with torch.no_grad():
                for t, tree in keep.items():
                    for n, p in tree.items():
                        for k, v in p.items():
                            state[t][n][k].copy_(v)
            return m

        return same

    return wrapped


def _half_step(make):
    def wrapped(*a, **kw):
        step = make(*a, **kw)
        return lambda state, batch: step(state, {k: v[: len(v) // 2] for k, v in batch.items()})

    return wrapped


def _late_half_step(make):
    """Sound for set-up's first steps and warm-up, half the batch after."""
    def wrapped(*a, **kw):
        step, calls = make(*a, **kw), [0]

        def late(state, batch):
            calls[0] += 1
            if calls[0] > 4:
                batch = {k: v[: len(v) // 2] for k, v in batch.items()}
            return step(state, batch)

        return late

    return wrapped


def _half_answer(call):
    def wrapped(self, batch):
        n = len(next(iter(batch.values())))
        out = call(self, {k: v[: n // 2] for k, v in batch.items()})
        return {k: np.concatenate([v, v])[:n] for k, v in out.items()}

    return wrapped


def _altered_answer(call):
    def wrapped(self, batch):
        return {k: np.roll(v, 1, axis=0) for k, v in call(self, batch).items()}

    return wrapped


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_train_step_is_not_correct(run_cell, monkeypatch, fault):
    from convnet_tpu_torch import trainer

    assert run_cell("tiny.train", 21)["correct"]
    wrap = _unchanged if fault == "unchanged" else _half_step
    monkeypatch.setattr(trainer, "make_train_step", wrap(trainer.make_train_step))
    assert not run_cell("tiny.train", 21)["correct"]


def test_a_step_that_breaks_after_set_up_is_not_correct(run_cell, monkeypatch):
    from convnet_tpu_torch import trainer

    monkeypatch.setattr(trainer, "make_train_step", _late_half_step(trainer.make_train_step))
    line = run_cell("tiny.train", 23)
    first = {k: c for k, c in line["checks"].items() if not k.startswith("after_")}
    assert all(c["value"] <= c["limit"] for c in first.values()), first
    assert not line["correct"]


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_broken_answers_are_not_correct(run_cell, monkeypatch, fault):
    from convnet_tpu_torch.predictor import Predictor

    assert run_cell("tiny.serve", 22)["correct"]
    wrap = _altered_answer if fault == "altered" else _half_answer
    monkeypatch.setattr(Predictor, "__call__", wrap(Predictor.__call__))
    assert not run_cell("tiny.serve", 22)["correct"]
