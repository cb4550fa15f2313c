"""The harness on the CPU: every piece of ``BENCHMARK.json`` found by name,
the file within the benchmark contract's limits, a tiny run of each cell
through the port's plain versions, and the ways a run must refuse."""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
#: sizes a CPU run can hold: fewer rows and background rows, a smaller
#: plan and chunk, every explained row judged (on the CPU the kernels'
#: wrappers run their plain versions)
TINY = {
    "covertype_lr": {"rows": 300, "explainer.instance_chunk": 128,
                     "explainer.background_rows": 10, "explainer.nsamples": 1000,
                     "judge.rows": 300},
    "adult_gbt": {"rows": 32, "explainer.background_rows": 10},
}


def test_benchmark_file_keeps_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51 and (rs + 60) * (2 + 14 * 24) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        names.add(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", []):
            assert "workloads" not in moved or cell in moved["workloads"], (m, cell)
    for item in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(item["name"])
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    from portbench import harness

    workload, config, traffic = harness.find_cell(SPEC, cell)
    assert callable(harness.kind_module(config).build)
    assert traffic["call"] in ("explain", "rank_features")
    e2e = {m["name"] for m in harness.end_to_end(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer(SPEC, cell)
    assert layer
    for m in layer:
        assert callable(harness.metric_reader(m["name"]).read)
    for name in config["limits"]:
        assert NAME.match(name)


def _tiny_run(cell, trace, seed=424242424242):
    ov = TINY[cell.split(".")[0]]
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness, run\n"
        f"line, checks = harness.run({cell!r}, {seed}, 1.0, {bool(trace)}, device='cpu', "
        f"overrides=json.loads({json.dumps(ov)!r}))\n"
        "print('loaded', harness.forbidden_modules(), file=sys.stderr)\n"
        "run.report(line, checks)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cpu_run_prints_a_well_formed_line(cell, trace):
    from portbench import harness

    line, err = _tiny_run(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["count"] == 1
    for name, entry in line["checks"].items():
        assert set(entry) == {"value", "limit"} and entry["value"] <= entry["limit"]
        assert f"check {name}: " in err
    if trace:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
        layer = {m["name"] for m in harness.per_layer(SPEC, cell)}
        assert set(line["metrics"]) <= layer
        assert any(harness.base_name(n) == "explain_mfu_pct" for n in line["metrics"])
    else:
        e2e = {m["name"]: m["unit"] for m in harness.end_to_end(SPEC, cell)}
        assert {k: v["unit"] for k, v in line["metrics"].items()} == e2e
    # nothing of JAX or the JAX package was loaded by the run
    assert "loaded []" in err


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if importlib.util.find_spec("torch") is None:
        pytest.skip("no torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_in_a_directory_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_nearest_rank_p95():
    from portbench.harness import p95

    assert p95([float(i) for i in range(1, 101)]) == 95.0
    assert p95([3.0]) == 3.0
    assert p95([float(i) for i in range(1, 21)]) == 19.0
