"""BENCHMARK.json against the contract's shape: names, units, keys, the
files each entry names, and the check's time budget."""

import json
import re

from benchmark.harness import HERE, ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(line(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic")) and line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    every = [m["name"] for m in M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]]
    assert len(every) == len(set(every))


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in M["workloads"]]
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(cells) // 4)
    for cell in cells:
        def mine(m):
            return cell in m.get("workloads", cells)
        e2e = [m for m in M["end_to_end"] if mine(m)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        layer = [m for m in M["per_layer"] if mine(m)]
        assert layer and all(m["moves"] in [e["name"] for e in e2e] for m in layer)
    for c in M["configs"]:
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
