"""The port's fp32 KD and accumulation steps against the reference's own fp32
noise, over rounding realizations, at 1 and at 8 torch threads, on the CPU.

``tests/test_torch_kd.py`` holds one fp32 run of each step (``kd``,
``accum``, ``kd_accum``) to fixed bounds at ``FP32_THREADS`` threads; one
rounding realization of a cancelling sum decides how close it comes. Here
every kind is read over ``REALIZATIONS`` states one ulp apart (the first the
state itself): the exact step is the port's float64 step from each state
(the reference's, to <= 1e-11 per leaf: ``test_torch_kd.py``
``test_update_matches``), and per field the median over realizations of the
worst leaf's distance, and the mean of the median leaf's (a few ties flip a
realization's median leaf by 100x), stay within 3x of the reference's jitted
fp32 step's, at 1 and at 8 threads alike. The seeds are fixed, so the check
is deterministic on a given machine and thread count.

The reference's fp32 step is compiled twice, not three times: ``accum`` and
``kd_accum`` share one jitted step that takes ``kd_alpha`` and the teacher's
trees as arguments (``accum`` at ``kd_alpha = 0``; ``test_torch_kd.py``
shows it in float64 to be the separate ``accum`` step); ``kd`` keeps its
own. The two compile in threads of their own while the port's float64 steps
run. 6 realizations keep every kind's and field's ratio at or below 1.8x at
both thread counts (12: 1.8x; 8: 2.9x); ``AXCNN_FP32_REALIZATIONS`` raises
the count.
"""

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from test_torch_kd import (
    KD_KW, STATE_SEEDS, TEACHER_SEED, _batch, _draws, _f64, _float64, _port_step,
    _reference_kd_accum_step, _reference_state, _reference_step, _teacher_trees, _threads)
from test_torch_train_step import LR_KW, ROOT_KEY, STEP_KW, _update_errors
import torch_inprocess

capped_threads = torch_inprocess.capped_threads

REALIZATIONS = int(os.environ.get("AXCNN_FP32_REALIZATIONS", "6"))
KINDS = ("kd", "accum", "kd_accum")
FIELDS = ("params", "velocity", "ema")
# the port's multiple of the reference's noise it may reach (per field: the
# worst leaf's median over realizations, the median leaf's mean)
RATIO_BOUND = 3.0


def _nudged(jstate, seed):
    """``jstate`` with every fp32 parameter moved by -1, 0 or +1 ulp at
    random (seed 0: unmoved)."""
    if seed == 0:
        return jstate
    rng = np.random.default_rng(seed)

    def nudge(a):
        step = rng.integers(-1, 2, np.shape(a)).astype(np.float32) * np.float32(2.0 ** -23)
        return (np.asarray(a, np.float32) * (np.float32(1.0) + step)).astype(np.float32)
    return jstate._replace(params=jax.tree.map(nudge, jstate.params))


def _errors(old, exact, got):
    """Per field: (the worst leaf's distance, the median leaf's) of ``got``'s
    update against ``exact``'s."""
    want = dataclasses.make_dataclass("Exact", FIELDS)(*(exact[f] for f in FIELDS))
    out = {}
    for f in FIELDS:
        errs = _update_errors(dict(old=old, want=want, got=got), f)
        out[f] = (max(errs.values()), float(np.median(list(errs.values()))))
    return out


@pytest.fixture(scope="module")
def realizations():
    """For each kind and realization: the state, the draws, the exact
    (port float64) step and the reference's jitted fp32 step's errors from
    it. The two reference steps are lowered here (fp32: outside
    ``_float64``), each compiling in a thread of its own while the next is
    lowered and the exact steps run."""
    key, trees = jax.random.key(ROOT_KEY), _teacher_trees(TEACHER_SEED)
    base = {kind: _reference_state(STATE_SEEDS[kind]) for kind in KINDS}
    with ThreadPoolExecutor(2) as pool:  # the longer compile first
        compiled = {"shared": pool.submit(_reference_kd_accum_step(
            LR_KW, STEP_KW, KD_KW["kd_temp"]).lower(base["kd_accum"], _batch(), key,
                                                     KD_KW["kd_alpha"], *trees).compile)}
        compiled["kd"] = pool.submit(
            _reference_step("kd", trees).lower(base["kd"], _batch(), key).compile)
        out = {}
        for kind in KINDS:
            kind_trees = trees if "kd" in kind else None
            with _float64():
                draws = _draws(accum="accum" in kind)
                runs = []
                for seed in range(REALIZATIONS):
                    jstate = _nudged(base[kind], seed)
                    exact = _port_step(jstate, kind, kind_trees, draws, torch.float64)[0]
                    runs.append(dict(jstate=jstate, old=jax.tree.map(_f64, jstate), exact=exact))
            out[kind] = dict(trees=kind_trees, draws=draws, runs=runs)
        compiled = {name: c.result() for name, c in compiled.items()}
    for kind in KINDS:
        if kind == "kd":
            reference = compiled["kd"]
        else:
            alpha = KD_KW["kd_alpha"] if kind == "kd_accum" else 0.0
            reference = functools.partial(_shared_call, compiled["shared"], alpha, trees)
        for run in out[kind]["runs"]:
            new = reference(run["jstate"], _batch(), key)[0]
            got = {f: jax.tree.map(lambda a: np.asarray(a, np.float64), getattr(new, f))
                   for f in FIELDS}
            run["reference"] = _errors(run["old"], run["exact"], got)
    return out


def _shared_call(compiled, alpha, trees, state, batch, key):
    return compiled(state, batch, key, alpha, *trees)


def _summary(errors):
    """Per field: the worst leaf's median over realizations, the median
    leaf's mean."""
    return {f: (float(np.median([e[f][0] for e in errors])),
                float(np.mean([e[f][1] for e in errors]))) for f in FIELDS}


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_fp32_noise_matches_the_reference_over_rounding_realizations(realizations, kind,
                                                                      threads):
    """The port's fp32 step on ``threads`` torch threads is as near the
    exact step as the reference's own jitted fp32 step, read over rounding
    realizations (module docstring): within ``RATIO_BOUND`` of it per field,
    by both readings. Prints every realization's readings and the worst
    ratio over the first 6, 8 and 12 realizations run."""
    data = realizations[kind]
    port = []
    with _threads(threads):
        for seed, run in enumerate(data["runs"]):
            got = _port_step(run["jstate"], kind, data["trees"], data["draws"],
                             torch.float32)[0]
            port.append(_errors(run["old"], run["exact"], got))
            for name, e in (("port", port[-1]), ("reference", run["reference"])):
                print(f"{kind} {threads} threads realization {seed} {name:9s} " + ", ".join(
                    f"{f} worst {e[f][0]:.3g} median {e[f][1]:.3g}" for f in FIELDS))
    reference = [run["reference"] for run in data["runs"]]
    for n in sorted({6, 8, 12, len(port)}):
        if n <= len(port):
            got, ref = _summary(port[:n]), _summary(reference[:n])
            print(f"{kind} {threads} threads, {n} realizations: worst ratio " + ", ".join(
                f"{f} {max(got[f][i] / ref[f][i] for i in range(2)):.3f}" for f in FIELDS))
    got, ref = _summary(port), _summary(reference)
    for f in FIELDS:
        print(f"{kind} {threads} threads {f}: worst leaf, median over realizations "
              f"{got[f][0]:.3g} (reference {ref[f][0]:.3g}); median leaf, mean {got[f][1]:.3g} "
              f"(reference {ref[f][1]:.3g})")
        assert got[f][0] <= RATIO_BOUND * ref[f][0], (f, got[f][0], ref[f][0])
        assert got[f][1] <= RATIO_BOUND * ref[f][1], (f, got[f][1], ref[f][1])
