"""One run of one cell: find its pieces by name, set it up, measure the
window, judge what the timed calls returned, read the trace.

Everything of a cell is found by name: the workload ``<config>.<mix>`` in
``BENCHMARK.json`` names its configuration (whose entry gives the file,
``configs/<config>.json``, which names its kind, ``kinds/<kind>.py``) and
its traffic mix (``traffic/<mix>.json``); each per-layer metric is read by
``metrics/<metric>.py``, a metric named ``<metric>.<part>`` by the same
reader (one quantity split where cells report different end-to-end
metrics).

The window is a closed loop with one caller: calls start back to back
until ``seconds`` have passed since the first began, and the window closes
when the last ends.  A call ends when its result is on the host as numpy.
What is judged of each result is kept between calls; the judging runs once
the window has closed and the port's objects are freed.
"""

import importlib
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "distributedkernelshap_tpu")


def load_spec(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def find_cell(spec: dict, name: str):
    """``(workload, config, traffic)`` of the cell ``name``."""

    workload = next((w for w in spec["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    with open(ROOT / entry["file"], encoding="utf-8") as fh:
        config = json.load(fh)
    with open(HERE / "traffic" / f"{workload['traffic']}.json", encoding="utf-8") as fh:
        traffic = json.load(fh)
    if traffic.get("loop") != "closed" or int(traffic.get("callers", 1)) != 1:
        raise ValueError(f"traffic {workload['traffic']!r}: only a closed loop with one "
                         "caller is generated")
    return workload, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(spec: dict, cell: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if applies(m, cell)]


def per_layer(spec: dict, cell: str) -> List[dict]:
    reported = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def kind_module(config: dict):
    return importlib.import_module(f"portbench.kinds.{config['kind']}")


def base_name(name: str) -> str:
    """The quantity a metric measures: its name up to the first dot (a
    quantity split by the cells' kinds or bounds, ``rows_per_s.rank``, is
    measured and read as ``rows_per_s``)."""

    return name.split(".")[0]


def metric_reader(name: str):
    return importlib.import_module(f"portbench.metrics.{base_name(name)}")


def p95(values: List[float]) -> float:
    """95th percentile by nearest rank."""

    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The closed loop's record."""

    def __init__(self):
        self.latencies: List[float] = []
        self.kept: List[dict] = []
        self.attempted = 0
        self.failed = 0
        self.rows = 0
        self.seconds = 0.0


def measure(system, traffic, seconds: float, device, tracing: bool) -> Window:
    """Run the window (under ``record_function`` ranges when ``tracing``)."""

    from torch.profiler import record_function

    win = Window()
    n_rows = system.rows(traffic).shape[0]
    _sync(device)
    opened = time.perf_counter()
    closed = opened
    while time.perf_counter() - opened < seconds:
        win.attempted += 1
        t0 = time.perf_counter()
        try:
            if tracing:
                with record_function("portbench.call"):
                    result = system.call(traffic)
            else:
                result = system.call(traffic)
        except Exception:  # a failed call counts against the attempted ones
            traceback.print_exc(file=sys.stderr)
            win.failed += 1
            closed = time.perf_counter()
            continue
        closed = time.perf_counter()
        win.latencies.append(closed - t0)
        win.rows += n_rows
        kept = system.keep(result, traffic, len(win.latencies) - 1)
        del result
        if kept is not None:
            win.kept.append(kept)
    win.seconds = closed - opened
    return win


class Stages:
    """Seconds from process start to the end of each named stage of set-up,
    so a run's line shows where its ``setup_s`` went."""

    def __init__(self, started: float):
        self.started = started
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> float:
        self.seconds[name] = time.perf_counter() - self.started
        return self.seconds[name]


def configure(cell: str, spec: dict, overrides: Optional[Dict] = None):
    """``(config, traffic)`` of ``cell``, with ``overrides`` (``"key"`` or
    ``"section.key"``: value) written over the configuration."""

    _, config, traffic = find_cell(spec, cell)
    for key, value in (overrides or {}).items():
        section, _, field = key.partition(".")
        if field:
            config[section][field] = value
        else:
            config[key] = value
    return config, traffic


def set_up(cell: str, seed: int, device, spec: dict, overrides: Optional[Dict] = None,
           stages: Optional[Stages] = None):
    """Build ``cell``'s system from ``seed`` on ``device`` and warm it with one
    call of the traffic's own shape; ``(system, traffic)``."""

    stages = stages or Stages(time.perf_counter())
    config, traffic = configure(cell, spec, overrides)
    stages.mark("imports")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        torch.empty(1, device=device)
    stages.mark("device")
    importlib.import_module("distributedkernelshap_tpu_torch")
    stages.mark("port import")
    system = kind_module(config).build(config, seed, device)
    stages.mark("build")
    warm = system.call(traffic)
    del warm
    _sync(device)
    stages.mark("warm call")
    return system, traffic


def free_program(system, device):
    """Let the port's objects go before the reference runs."""

    system.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: str, seed: int, seconds: float, trace: bool, device="cuda:0",
        spec: Optional[dict] = None, overrides: Optional[Dict] = None,
        started: Optional[float] = None):
    """One run; returns ``(line, checks)`` where ``line`` is the result
    object and ``checks`` the compared numbers with their limits."""

    started = time.perf_counter() if started is None else started
    stages = Stages(started)
    spec = spec or load_spec()
    device = torch.device(device)
    system, traffic = set_up(cell, seed, device, spec, overrides, stages)
    launches0 = system.launches()

    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        profiler = profile(activities=acts)
        profiler.__enter__()
    setup_s = stages.mark("profiler" if trace else "launch counters")
    win = measure(system, traffic, seconds, device, tracing=trace)
    if profiler is not None:
        profiler.__exit__(None, None, None)
    launches = {k: v - launches0[k] for k, v in system.launches().items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    calls = len(win.latencies)

    free_program(system, device)

    line = {"correct": False, "attempted": win.attempted, "failed": win.failed,
            "metrics": {}, "device": {}}
    if device.type == "cuda":
        line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                          "count": 1, "memory_peak_bytes": int(peak)}
    else:
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                          "memory_peak_bytes": 0}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}

    if not trace:
        values = {"setup_s": setup_s}
        if calls:
            values["rows_per_s"] = win.rows / win.seconds
            values["call_p95_ms"] = 1e3 * p95(win.latencies)
        for m in end_to_end(spec, cell):
            if base_name(m["name"]) in values:
                line["metrics"][m["name"]] = {"value": values[base_name(m["name"])],
                                              "unit": m["unit"]}
    else:
        from portbench import trace as tracing

        record, breakdown = tracing.reduce(profiler, calls)
        if record is not None:
            line["device"]["busy_s"] = record.busy_s
            line["device"]["window_s"] = record.window_s
            record.work = system.work(traffic, device) if calls else {}
            for m in per_layer(spec, cell):
                value = metric_reader(m["name"]).read(record)
                if value is not None:
                    line["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
            line["breakdown"] = breakdown
    lat = sorted(win.latencies)
    line["counters"] = {"calls": calls, "rows_per_call": system.rows(traffic).shape[0],
                        "window_s": win.seconds,
                        "call_ms": [1e3 * lat[0], 1e3 * lat[len(lat) // 2], 1e3 * lat[-1]]
                        if lat else [],
                        "setup_stages_s": stages.seconds,
                        "launches": launches,
                        "launches_per_call": {k: v / calls for k, v in launches.items()}
                        if calls else {}}

    checks = system.judge(win.kept, traffic, device) if win.kept else []
    line["correct"] = bool(checks) and win.failed == 0 and all(
        v <= lim for _, v, lim in checks)
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line, checks
