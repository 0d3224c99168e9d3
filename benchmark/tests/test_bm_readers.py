"""Every per-layer reader of a cell reads a traced run without failing,
and returns nothing or a number (a share of a peak or a roofline within
100%)."""

import math

import pytest

from benchmark import harness

from .conftest import run_cell, tiny


@pytest.mark.parametrize("name", ["ar50_train_b256", "ar50_serve_b128_open"])
def test_readers_read_a_traced_run(name):
    cell = tiny(name)
    out = run_cell(cell, seconds=1.0, trace=True)
    assert out["correct"] and out["window"].units >= 1
    run = harness.TracedRun(cell, "cpu", out)
    for m in cell.per_layer:
        v = harness.read(m["name"], run)
        assert v is None or math.isfinite(v)
        if v is not None and m["unit"] == "%":
            assert v <= 100.0
