"""A run comes out not correct when the timed path is broken underneath,
once for each fault a cell can have, and when the lower-precision control
takes the program's place; a sound run of the same size comes out
correct. Each drives the rest of a run on the CPU, the look for a card
skipped."""

import numpy as np
import pytest
import torch

from benchmark import judge, program
from benchmark.drivers import serve_open, train_synthetic
from benchmark.harness import ROOT
from benchmark.reference.step import fp8_round

from .conftest import run_cell, tiny

TRAIN = "ar50_train_b256"


def test_sound_training_run_is_correct():
    assert run_cell(tiny(TRAIN))["correct"]


def test_step_that_returns_its_state_unchanged(monkeypatch):
    def frozen(config, traffic, group=None):
        def step(state, batch, seed):
            return state, {"loss": torch.zeros(())}
        return step

    monkeypatch.setattr(program, "train_step_fn", frozen)
    assert not run_cell(tiny(TRAIN))["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    make = program.train_step_fn

    def halved(config, traffic, group=None):
        real = make(config, traffic, group)

        def step(state, batch, seed):
            n = batch["labels"].shape[0] // 2
            return real(state, {k: v[:n] for k, v in batch.items()}, seed)
        return step

    monkeypatch.setattr(program, "train_step_fn", halved)
    assert not run_cell(tiny(TRAIN))["correct"]


NO_EXCHANGE = """
import benchmark.program as p
make = p.train_step_fn
p.train_step_fn = lambda config, traffic, group=None: make(config, traffic, None)
"""


@pytest.mark.parametrize("exchange", [True, False])
def test_the_exchange_between_ranks_left_out(monkeypatch, tmp_path, exchange):
    """Two ranks over Gloo; without the exchange each rank steps on its
    shard alone (the step built with no process group), in every rank's
    process: the started ranks take the fault from a ``sitecustomize``."""
    if not exchange:
        (tmp_path / "sitecustomize.py").write_text(NO_EXCHANGE)
        monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
        make = program.train_step_fn
        monkeypatch.setattr(program, "train_step_fn",
                            lambda config, traffic, group=None: make(config, traffic, None))
    out = run_cell(tiny(TRAIN, ranks=2))
    assert out["correct"] == exchange


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    cell = tiny("ar50_serve_b128_open")
    assert run_cell(cell)["correct"]
    real = program.serve_fn

    def altered(state, dtype):
        fn = real(state, dtype)
        calls = []

        def serve(images):
            out = fn(images)
            calls.append(1)
            if len(calls) == 3:
                out = out.clone()
                out[0] = out[0].flip(0)
            return out
        return serve

    monkeypatch.setattr(program, "serve_fn", altered)
    assert not run_cell(cell)["correct"]


def test_training_control_is_not_correct():
    """The reference in float8, in the program's place, against the
    reference in float32."""
    cell = tiny(TRAIN)
    dev = torch.device("cpu")
    ref = train_synthetic.reference_readings(cell, 21, dev)
    control = train_synthetic.reference_readings(cell, 21, dev, quant=fp8_round)
    checked = judge.checks(judge.train_numbers(control, ref), cell.limits)
    assert not judge.is_correct(checked)


def test_serving_control_is_not_correct():
    """The program's own int8 path, judged as the bf16 one is."""
    cell = tiny("ar50_serve_b128_open")
    dev = torch.device("cpu")
    s = serve_open.serve(cell, 8, 0.5, False, 0.0, dev, dtype="int8")
    ref = serve_open.reference_logits(cell, 8, dev)
    answered = torch.from_numpy(np.isfinite(s["lat"]))
    checked = judge.checks(judge.serve_numbers(s["answers"], answered, s["images"], ref),
                           cell.limits)
    assert not judge.is_correct(checked)
