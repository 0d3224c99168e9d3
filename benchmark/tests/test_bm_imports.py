"""Nothing the harness imports is JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

import subprocess
import sys

from benchmark.harness import FORBIDDEN, ROOT

HARNESS = ["benchmark.run", "benchmark.check_limits", "benchmark.sweep_knee",
           "benchmark.drivers.train_synthetic", "benchmark.drivers.serve_open"]


def _loaded(modules, extra=""):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules) + extra +
            "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    readers = ("from benchmark import harness\n"
               "for m in harness.Cell('ar50_train_b256').manifest['per_layer']:\n"
               "    harness.read(m['name'], None) if False else None\n")
    loaded = _loaded(HARNESS, readers)
    assert "axcnn_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "axcnn_torchlike", sys)
    assert "axcnn" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "axcnn.sub", sys)
    assert "axcnn" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded(["benchmark.reference.model", "benchmark.reference.step",
                      "benchmark.reference.draws", "benchmark.weights", "benchmark.judge",
                      "benchmark.work", "benchmark.trace"])
    assert not loaded & {"axcnn_torch", *FORBIDDEN}
