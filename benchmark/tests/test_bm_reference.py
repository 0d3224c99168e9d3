"""The plain reference against the program, at a size the CPU runs, in
float32: the reference's model, step and draws are written apart from the
program's, so their agreement here is what lets the judge trust them at
the cell's size on the card."""

import pytest
import torch

from benchmark import judge, program
from benchmark.drivers import serve_open, train_synthetic
from benchmark.reference.model import param_shapes

from .conftest import tiny


@pytest.mark.parametrize("name", ["ar50_train_b256", "r50_train_b256"])
def test_parameters_and_decay_rule_match_the_program(name):
    from axcnn_torch.train.losses import decay_mask

    cell = tiny(name)
    state = program.build_state(cell.config, 3, torch.device("cpu"), use_ema=False)
    shapes = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    assert shapes == {k: tuple(v) for k, v in param_shapes(cell.config["model"]).items()}
    mask = decay_mask(state.model)
    assert all(mask[k] == (len(v) >= 2) for k, v in shapes.items())


@pytest.mark.parametrize("name", ["ar50_train_b256", "r50_train_b256"])
def test_training_steps_agree(name):
    cell = tiny(name)
    dev = torch.device("cpu")
    state = program.build_state(cell.config, 11, dev, use_ema=cell.config["train"]["use_ema"])
    state.step = cell.traffic["start_step"]
    pool = train_synthetic.Pool(cell.config, cell.traffic, 11, dev, 1)
    prog = train_synthetic.program_readings(state, program.train_step_fn(cell.config, cell.traffic),
                                            pool, 11, 0, cell.traffic["checked_steps"])
    ref = train_synthetic.reference_readings(cell, 11, dev)
    got = judge.train_numbers(prog, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 2e-3 and got["bnstat_gap"] < 1e-4
    assert got["param_gap"] < 2e-2  # fp32 parameters resolve a warmup step's change to ~1e-3


def test_served_logits_agree():
    cell = tiny("ar50_serve_b128_open")
    dev = torch.device("cpu")
    state = program.build_state(cell.config, 5, dev, use_ema=False)
    images = serve_open.make_images(cell.traffic["pool_images"], 64, 5, dev)
    got = program.serve_fn(state, "fp32")(images)
    ref = serve_open.reference_logits(cell, 5, dev)
    assert float(((got - ref).norm(dim=1) / ref.norm(dim=1)).max()) < 1e-4


def test_float32_reference_agrees_with_itself_in_float64():
    cell = tiny("r50_train_b256")
    dev = torch.device("cpu")
    ref = train_synthetic.reference_readings(cell, 11, dev)
    ref64 = train_synthetic.reference_readings(cell, 11, dev, dtype=torch.float64)
    got = judge.train_numbers(ref, ref64)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 5e-3 and got["bnstat_gap"] < 1e-4


def test_bf16_witness_rounds_both_ways():
    from benchmark.reference.step import bf16_round

    x = torch.randn(64, dtype=torch.float64, requires_grad=True)
    g = torch.randn(64, dtype=torch.float64)
    y = bf16_round(x)
    y.backward(g)
    assert torch.equal(y.detach(), x.detach().to(torch.bfloat16).to(torch.float64))
    assert torch.equal(x.grad, g.to(torch.bfloat16).to(torch.float64))
    assert not torch.equal(y.detach(), x.detach())
