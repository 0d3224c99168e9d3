"""The open loop's arrivals and batching are fixed by the seed, and the
tails and the rate cover every request and the whole window."""

import math

import numpy as np
import pytest

from benchmark.drivers.serve_open import Schedule, batch_size_at, ready_at, tails
from benchmark.drivers.train_synthetic import rate

TRAFFIC = {"rate_per_s": 1350, "pool_images": 1024}


def simulated_batches(due, batch=128, timeout=0.25):
    """The batcher's choices when every dispatch happens when it may."""
    out, first = [], 0
    while first < len(due):
        t = ready_at(due, first, batch, timeout)
        n = batch_size_at(due, first, batch, t)
        out.append((first, n, t))
        first += n
    return out


def test_schedule_is_fixed_by_the_seed():
    a, b = Schedule(TRAFFIC, 2 ** 31 + 7, 30.0), Schedule(TRAFFIC, 2 ** 31 + 7, 30.0)
    assert np.array_equal(a.due, b.due) and np.array_equal(a.image, b.image)
    assert simulated_batches(a.due) == simulated_batches(b.due)


def test_every_seed_offers_the_same_gaps_inside_the_window():
    a, b = Schedule(TRAFFIC, 1, 30.0), Schedule(TRAFFIC, 2, 30.0)
    assert len(a.due) == len(b.due) == 1350 * 30
    def gaps(s):
        return np.sort(np.append(np.diff(s.due), 30.0 - s.due[-1]))

    assert np.allclose(gaps(a), gaps(b), rtol=0, atol=1e-9)
    assert not np.array_equal(a.due, b.due)
    assert a.due[0] == 0.0 and a.due[-1] < 30.0
    assert a.image.min() >= 0 and a.image.max() < 1024


def test_batches_are_full_or_timed_out():
    due = Schedule(TRAFFIC, 5, 10.0).due
    batches = simulated_batches(due)
    assert sum(n for _, n, _ in batches) == len(due)
    for first, n, t in batches[:-1]:
        assert n == 128 and t == due[first + 127]
    first, n, t = batches[-1]
    assert n <= 128 and t <= due[first] + 0.25 + 1e-12
    sparse = np.array([0.0, 0.1, 0.5])
    assert simulated_batches(sparse, timeout=0.25) == [(0, 2, 0.25), (2, 1, 0.75)]


def test_tails_cover_every_request_and_count_the_unanswered_as_missing():
    lat = np.linspace(0.001, 0.1, 100)
    assert tails(lat, np.ones(100, bool)) == pytest.approx((0.051, 0.096))
    answered = np.ones(100, bool)
    answered[:4] = False
    assert math.isfinite(tails(lat, answered)[1])
    answered[:6] = False
    assert tails(lat, answered)[1] == math.inf


def test_rate_is_every_ranks_images_over_the_whole_window():
    ranks = [{"steps": 10, "elapsed": 4.0}, {"steps": 10, "elapsed": 5.0}]
    assert rate(ranks, 256) == 20 * 256 / 5.0
