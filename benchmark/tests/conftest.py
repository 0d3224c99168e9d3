"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (a quarter of the widths, 64x64 images, a few images a
card), in float32 so that the program and the reference agree to rounding
and the cell's own limits hold."""

import time

import pytest
import torch


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny(name: str, dtype: str = "fp32", **traffic):
    from benchmark.harness import Cell

    cell = Cell(name)
    cell.config["model"].update(width_multiplier=0.25, num_classes=10)
    cell.config["image_size"] = 64
    cell.config["dtype"] = dtype
    if cell.traffic["kind"] == "serve_open":
        cell.traffic.update(rate_per_s=100, batch=8, pool_images=16, warm_batches=1, trace_s=0.3)
    else:
        cell.traffic.update(per_card_batch=4, warm_steps=1, trace_steps=1, enqueue_probe_steps=1)
    cell.traffic.update(traffic)
    return cell


def run_cell(cell, seconds=0.5, trace=False, seed=123456789012):
    """The cell's driver on the CPU, the harness's look for a card skipped."""
    import importlib

    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    return driver.run(cell, seed, seconds, trace, time.perf_counter(), torch.device("cpu"))
