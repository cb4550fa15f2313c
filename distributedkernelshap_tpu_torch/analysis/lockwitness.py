"""Runtime lock-order witness (TSan-lite) for the named control-plane
locks.

The static analyzer (:mod:`.concurrency`) proves lock-order safety only
per class; cross-object ordering (server lock -> registry condition ->
metrics lock, taken on different threads) is a runtime property.  This
module is the runtime half of the contract:

* Modules create their control-plane locks through :func:`make_lock` /
  :func:`make_rlock` / :func:`make_condition` with a stable dotted name
  (``"scheduler.cond"``, ``"registry.swap"``).  With the witness OFF
  (the default) these return plain ``threading`` primitives — zero
  overhead, nothing recorded.
* With ``DKS_LOCK_WITNESS=1`` in the environment at lock-creation time,
  the factories return :class:`WitnessedLock` wrappers that record, per
  thread, the acquisition order of held locks into one process-wide
  directed graph (edge ``A -> B`` = "B was acquired while A was held"),
  plus per-lock max hold times and the witness's own bookkeeping
  overhead.
* At teardown, :func:`assert_clean` fails on any cycle in the graph (a
  real deadlock needs the threads to interleave; the witness catches the
  ORDER inversion even when the run got lucky) and on any hold time
  above the budget (``DKS_LOCK_WITNESS_MAX_HOLD_S``, default 1.0 s —
  control-plane locks must never bracket device work or network I/O).

Wired into ``tests/conftest.py`` (session teardown when the env knob is
set, plus the tier-1 smoke in ``tests/test_lockwitness.py``) and into
``benchmarks/chaos_bench.py --check`` so the chaos scenarios double as
witness workloads.

Known limitation: the graph is keyed by the factory NAME, so the
relative order of two distinct instances sharing one name (two models'
``registry.model`` conditions, two clients' ``admission.bucket``) is
not order-checked — a same-name edge would be an instant false cycle.
Such nestings are counted per name and surfaced as
``snapshot()["same_name_nestings"]`` instead, so a workload that starts
exercising one can be given per-instance names deliberately.
"""

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

ENV_KNOB = "DKS_LOCK_WITNESS"
MAX_HOLD_ENV = "DKS_LOCK_WITNESS_MAX_HOLD_S"
DEFAULT_MAX_HOLD_S = 1.0

_tls = threading.local()
_graph_lock = threading.Lock()
#: edge -> count of observations
_edges: Dict[Tuple[str, str], int] = {}
#: lock name -> (max observed hold seconds, acquisition count)
_holds: Dict[str, List[float]] = {}
#: name -> count of nestings of two DISTINCT instances sharing that name
#: (their relative order is not verifiable through the name-keyed graph;
#: known limitation, see docs/STATIC_ANALYSIS.md)
_self_nests: Dict[str, int] = {}
#: accumulated witness bookkeeping seconds (the overhead accounting the
#: chaos bench asserts against its wall clock)
_overhead_s = 0.0


#: in-process override (see :func:`force_enable`) — deliberately NOT the
#: env knob, so it never leaks into spawned child processes
_forced = False


def enabled() -> bool:
    """Consulted at lock-creation time (not import time), so a test can
    flip the env knob before constructing the object under test."""

    return _forced or \
        os.environ.get(ENV_KNOB, "") not in ("", "0", "false", "off")


def force_enable(on: bool = True) -> None:
    """Enable the witness for THIS process only, without touching the
    environment.  The chaos bench uses this: setting ``DKS_LOCK_WITNESS``
    in ``os.environ`` would be inherited by every replica worker it
    spawns, silently taxing the hot-path locks whose latencies the bench
    records into ``results/perf_history.jsonl`` — while the witness
    overhead assertion only ever covers the parent's bookkeeping."""

    global _forced
    _forced = bool(on)


def _stack() -> List[Tuple[str, float]]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class WitnessedLock:
    """Wraps a ``threading`` lock, recording acquisition-order edges and
    hold times.  Duck-compatible with ``threading.Condition``'s lock
    protocol (``acquire``/``release``/context manager)."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            global _overhead_s
            t0 = time.perf_counter()
            stack = _stack()
            with _graph_lock:
                for held_name, held_id, _ in stack:
                    if held_name != self.name:
                        edge = (held_name, self.name)
                        _edges[edge] = _edges.get(edge, 0) + 1
                    elif held_id != id(self):
                        # two INSTANCES sharing one name nested: their
                        # relative order cannot be verified through the
                        # name-keyed graph (and a self-edge would be a
                        # false cycle) — surfaced in snapshot() instead
                        _self_nests[self.name] = \
                            _self_nests.get(self.name, 0) + 1
                stack.append((self.name, id(self), time.perf_counter()))
                # overhead accumulates under _graph_lock: it is itself a
                # cross-thread shared write (the DKS-C001 class), and the
                # chaos bench gates on its value
                _overhead_s += time.perf_counter() - t0
        return got

    def release(self):
        global _overhead_s
        t0 = time.perf_counter()
        stack = _stack()
        # release matches the most recent acquisition of THIS instance
        # (an RLock can nest; unlocking out of order is tolerated — the
        # witness observes, it does not enforce scoping)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == self.name and stack[i][1] == id(self):
                held_s = time.perf_counter() - stack[i][2]
                del stack[i]
                with _graph_lock:
                    bucket = _holds.setdefault(self.name, [0.0, 0.0])
                    bucket[0] = max(bucket[0], held_s)
                    bucket[1] += 1
                    _overhead_s += time.perf_counter() - t0
                break
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_lock(name: str):
    """A named mutex: plain ``threading.Lock`` with the witness off."""

    if not enabled():
        return threading.Lock()
    return WitnessedLock(name, threading.Lock())


def make_rlock(name: str):
    if not enabled():
        return threading.RLock()
    return WitnessedLock(name, threading.RLock())


def make_condition(name: str):
    """A named condition variable.  ``Condition.wait`` releases through
    the wrapper, so hold-time accounting pauses across waits."""

    return threading.Condition(make_lock(name))


# --------------------------------------------------------------------- #
# inspection / teardown
# --------------------------------------------------------------------- #


def snapshot() -> Dict:
    """Copy of the process-wide witness state."""

    with _graph_lock:
        edges = dict(_edges)
        holds = {name: tuple(v) for name, v in _holds.items()}
        overhead = _overhead_s
        self_nests = dict(_self_nests)
    return {
        "edges": edges,
        "max_hold_s": {name: v[0] for name, v in holds.items()},
        "acquisitions": {name: int(v[1]) for name, v in holds.items()},
        "same_name_nestings": self_nests,
        "overhead_s": overhead,
    }


def reset() -> None:
    global _overhead_s
    with _graph_lock:
        _edges.clear()
        _holds.clear()
        _self_nests.clear()
        _overhead_s = 0.0


def find_cycle_in_edges(edges) -> Optional[List[str]]:
    from distributedkernelshap_tpu_torch.analysis.concurrency import find_cycle

    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    return find_cycle(graph)


def problems(max_hold_s: Optional[float] = None) -> List[str]:
    """Human-readable violations (empty = clean)."""

    if max_hold_s is None:
        try:
            max_hold_s = float(os.environ.get(MAX_HOLD_ENV,
                                              DEFAULT_MAX_HOLD_S))
        except ValueError:
            max_hold_s = DEFAULT_MAX_HOLD_S
    snap = snapshot()
    out: List[str] = []
    cycle = find_cycle_in_edges(snap["edges"])
    if cycle is not None:
        out.append("lock-order cycle observed at runtime: "
                   + " -> ".join(cycle))
    for name, held in sorted(snap["max_hold_s"].items()):
        if held > max_hold_s:
            out.append(f"lock {name!r} held {held:.3f}s "
                       f"(budget {max_hold_s:.3f}s) — control-plane "
                       f"locks must not bracket blocking work")
    return out


def assert_clean(max_hold_s: Optional[float] = None) -> Dict:
    """Raise ``AssertionError`` on any witness violation; returns the
    snapshot so callers can report edge/acquisition counts."""

    issues = problems(max_hold_s)
    if issues:
        raise AssertionError("lockwitness: " + "; ".join(issues))
    return snapshot()
