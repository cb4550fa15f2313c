"""The traced run's records: what ran on the device inside the window, and
what the host was doing while the device stood idle.

The window runs under ``torch.profiler`` (CPU and CUDA activities); each
timed call sits in a ``portbench.call`` range the harness opens, so the
traced window is the span from the first call's start to the last call's
end on the profiler's own clock.  Device operations are the CUPTI kernel,
memcpy and memset records, clipped to that window.
"""

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

CALL_RANGE = "portbench.call"


@dataclass
class Op:
    name: str
    kind: str          # 'kernel', 'memcpy', 'memset' or 'cpu'
    start: float       # seconds on the profiler's clock
    end: float


@dataclass
class Record:
    """What a per-layer metric reader reads (``metrics/<name>.py``)."""

    window_s: float
    busy_s: float
    calls: int
    device_ops: List[Op]
    work: Dict[str, dict] = field(default_factory=dict)

    def seconds(self, ops: List[Op]) -> float:
        return sum(o.end - o.start for o in ops)

    def kernels(self, *prefixes: str) -> List[Op]:
        return [o for o in self.device_ops if o.kind == "kernel"
                and short_name(o.name).startswith(prefixes)]


def short_name(name: str) -> str:
    """A kernel's function name without its namespaces, return type,
    template arguments or parameter list; a copy's direction."""

    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s.split("::")[-1] or name


def _kind(event) -> Optional[str]:
    """'cpu' for host events, 'kernel', 'memcpy' or 'memset' for device
    operations, None for the rest (the device-side copies of annotations)."""

    act = getattr(event, "activity_type", None)
    act = str(act()).lower() if callable(act) else ""
    name = event.name()
    if "cuda" not in str(event.device_type()).lower():
        return "cpu"
    if "annotation" in act or name == CALL_RANGE:
        return None
    if "memcpy" in act or name.startswith("Memcpy"):
        return "memcpy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    if "kernel" in act or act == "":
        return "kernel"
    return None


def ops_of(prof) -> List[Op]:
    """Every CPU and device operation the profiler recorded."""

    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is None:
            continue
        start = e.start_ns() * 1e-9
        out.append(Op(e.name(), kind, start, start + e.duration_ns() * 1e-9))
    return out


def window_of(ops: List[Op]) -> Optional[Tuple[float, float]]:
    calls = [o for o in ops if o.kind == "cpu" and o.name == CALL_RANGE]
    if not calls:
        return None
    return min(o.start for o in calls), max(o.end for o in calls)


def clip(ops: List[Op], lo: float, hi: float) -> List[Op]:
    out = []
    for o in ops:
        s, e = max(o.start, lo), min(o.end, hi)
        if e > s:
            out.append(Op(o.name, o.kind, s, e))
    return out


def merged(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, in order."""

    spans: List[Tuple[float, float]] = []
    for o in sorted(ops, key=lambda o: o.start):
        if spans and o.start <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], o.end))
        else:
            spans.append((o.start, o.end))
    return spans


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float):
    edges = [lo] + [t for s in busy for t in s] + [hi]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def host_labels(cpu: List[Op], gaps: List[Tuple[float, float]]) -> List[str]:
    """What the host was doing over each idle gap (in order): the innermost
    profiled host operation at the gap's middle, inside or between the
    timed calls."""

    import heapq

    cpu = sorted(cpu, key=lambda o: o.start)
    active: List[Tuple[float, int]] = []
    labels, i = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(cpu) and cpu[i].start <= mid:
            heapq.heappush(active, (cpu[i].end, i))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        covering = [cpu[j] for _, j in active]
        where = "call" if any(o.name == CALL_RANGE for o in covering) else "between calls"
        inner = [o for o in covering if o.name != CALL_RANGE]
        if inner:
            op = min(inner, key=lambda o: o.end - o.start)
            labels.append(f"{where}: {short_name(op.name)}")
        else:
            labels.append(f"{where}: host code outside torch ops")
    return labels


def reduce(prof, calls: int):
    """``(record, breakdown)`` of a traced window, or ``(None, None)`` when
    the profiler recorded no timed call."""

    ops = ops_of(prof)
    win = window_of(ops)
    if win is None:
        return None, None
    lo, hi = win
    inside = clip(ops, lo, hi)
    device = [o for o in inside if o.kind != "cpu"]
    busy = merged(device)
    busy_s = sum(e - s for s, e in busy)
    record = Record(window_s=hi - lo, busy_s=busy_s, calls=calls, device_ops=device)
    by_name: Dict[str, float] = {}
    for o in device:
        key = short_name(o.name)
        by_name[key] = by_name.get(key, 0.0) + (o.end - o.start)
    gaps = idle_gaps(busy, lo, hi)
    by_label: Dict[str, float] = {}
    for (a, b), key in zip(gaps, host_labels([o for o in inside if o.kind == "cpu"], gaps)):
        by_label[key] = by_label.get(key, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return record, {"device_ops": top(by_name), "idle_gaps": top(by_label)}
