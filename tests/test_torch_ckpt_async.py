"""Asynchronous saves of the port's checkpoint manager, on the CPU: the
snapshot, the writer's errors, the step in flight and the single writer.

The state is tests/test_torch_ckpt.py's (assembled R50 at width 0.125, every
field unlike a fresh one, step 7). ``torch.save`` is wrapped to hold the
writer thread back (a sleep, or an event the test sets), so that what the
test does while a save is in flight is certain to happen before the write.
"""

import os
import threading
import time

import pytest
import torch

from axcnn_torch.ckpt.checkpoint import CheckpointManager
from test_torch_ckpt import _state
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

_SAVE = torch.save


def _held(monkeypatch, hold):
    """Make the writer call ``hold()`` before it pickles."""
    def save(obj, f):
        hold()
        _SAVE(obj, f)

    monkeypatch.setattr(torch, "save", save)


def _tensors(state):
    return {"model": state.model.state_dict(), "velocity": state.velocity, "ema": state.ema}


def test_tensors_changed_after_save_returns_do_not_reach_the_file(tmp_path, monkeypatch):
    """The optimizer and the EMA update the live tensors in place as soon as
    ``save`` returns; the file holds the values at the call."""
    state = _state(0)
    want = {f: {k: t.clone() for k, t in d.items()} for f, d in _tensors(state).items()}
    _held(monkeypatch, lambda: time.sleep(0.3))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(state)
    with torch.no_grad():
        for d in _tensors(state).values():
            for t in d.values():
                t.add_(1.0)
    raw = mgr.load()
    got = {"model": {**raw["params"], **raw["model_state"]}, "velocity": raw["velocity"],
           "ema": raw["ema"]}
    for field, d in want.items():
        assert set(got[field]) == set(d), field
        for k, t in d.items():
            assert torch.equal(got[field][k], t), (field, k)
            assert not torch.equal(_tensors(state)[field][k], t), (field, k)


@pytest.mark.parametrize("joiner", ["wait", "save", "load", "restore", "close"])
def test_a_writer_error_is_raised_by_the_next_call_that_joins_it(tmp_path, monkeypatch, joiner):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(1)
    mgr.save(state)
    mgr.wait()

    def full():
        raise OSError("no space left on device")

    _held(monkeypatch, full)
    state.step = 8
    assert mgr.save(state)  # the snapshot is taken; the write fails later
    calls = {"wait": mgr.wait, "load": mgr.load, "close": mgr.close,
             "save": lambda: mgr.save(state), "restore": lambda: mgr.restore(_state(2))}
    with pytest.raises(OSError, match="no space left"):
        calls[joiner]()
    mgr.wait()  # raised once
    assert sorted(os.listdir(tmp_path)) == ["7.pt"] and mgr.latest_step() == 7


def test_the_step_in_flight_counts_as_written(tmp_path, monkeypatch):
    """While step 8 is being written, ``latest_step``/``all_steps`` show it
    (and step 7 gone, as retention will leave it), so no step is written
    twice; a second ``save`` first joins the one in flight."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    state = _state(2)
    mgr.save(state)
    mgr.wait()
    release, seen = threading.Event(), []

    def hold():  # the checkpoints on disk as each write begins
        release.wait()
        seen.append(sorted(f for f in os.listdir(tmp_path) if f.endswith(".pt")))

    _held(monkeypatch, hold)
    state.step = 8
    assert mgr.save(state)
    assert mgr.latest_step() == 8 and mgr.all_steps() == [8]
    assert sorted(os.listdir(tmp_path))[0] == "7.pt"
    threading.Timer(0.2, release.set).start()
    state.step = 9
    assert mgr.save(state)  # joins step 8's writer, then starts step 9's
    mgr.wait()
    assert seen == [["7.pt"], ["8.pt"]]
    assert sorted(os.listdir(tmp_path)) == ["9.pt"] and mgr.all_steps() == [9]
