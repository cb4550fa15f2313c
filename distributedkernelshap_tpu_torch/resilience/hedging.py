"""Tail-latency request hedging: policy + per-class quantile tracking.

A single slow replica (background compaction, a first compile, a noisy
neighbour) inflates the fan-in's tail latency far beyond the fleet
median — the classic "tail at scale" problem.  The cure is hedging: when
a request has waited past the class's observed latency quantile, dispatch
a second copy to a different replica and take whichever answers first.

Hedging is safe here because explanations are deterministic and
content-addressed (``scheduling/result_cache.py``): the duplicate
execution produces a bit-identical payload under the same cache key, the
proxy returns exactly one answer per client request, and the loser's
response is discarded — double execution can never double-count or
surface two answers.  The only cost is the duplicated device work, which
the delay bounds to the slowest few percent of requests.

The policy is consulted by
:meth:`~distributedkernelshap_tpu_torch.serving.replicas.FanInProxy.handle_explain`;
this module holds the policy + tracker so they are testable without HTTP.
"""

import threading
from collections import deque
from typing import Dict, Optional

__all__ = ["LatencyQuantiles", "HedgePolicy"]


class LatencyQuantiles:
    """Streaming per-class latency quantiles over a sliding window.

    A bounded deque per class (default 512 samples) — at fan-in request
    rates the window spans recent-enough history, and an exact quantile
    over <= 512 floats is cheaper than maintaining a sketch.  Thread-safe.
    """

    def __init__(self, window: int = 512):
        self.window = int(window)
        self._samples: Dict[str, deque] = {}
        self._lock = threading.Lock()

    def observe(self, klass: str, seconds: float) -> None:
        with self._lock:
            dq = self._samples.get(klass)
            if dq is None:
                dq = self._samples[klass] = deque(maxlen=self.window)
            dq.append(float(seconds))

    def quantile(self, klass: str, q: float) -> Optional[float]:
        """The q-quantile of the class's window, or ``None`` with no
        samples (the policy falls back to its initial delay)."""

        with self._lock:
            dq = self._samples.get(klass)
            if not dq:
                return None
            ordered = sorted(dq)
        # nearest-rank over the (<=window)-sample sort — exact and cheap
        rank = min(len(ordered) - 1,
                   max(0, int(round(q * (len(ordered) - 1)))))
        return ordered[rank]

    def count(self, klass: str) -> int:
        with self._lock:
            dq = self._samples.get(klass)
            return len(dq) if dq else 0


class HedgePolicy:
    """When and whether to hedge.

    ``delay_for`` returns the wait before dispatching the hedge: the
    class's ``quantile`` of observed latency (default p95 — hedge only
    the slowest ~5%), clamped to ``[min_delay_s, max_delay_s]``.  Before
    ``min_samples`` observations exist for the class the tracker is too
    noisy to trust, so ``initial_delay_s`` applies — choose it near the
    expected worst-case healthy latency so cold-start traffic does not
    hedge-storm a fleet that is merely compiling.
    """

    def __init__(self, quantile: float = 0.95,
                 min_delay_s: float = 0.05,
                 max_delay_s: float = 30.0,
                 initial_delay_s: float = 2.0,
                 min_samples: int = 10):
        if not 0.0 < quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        if min_delay_s <= 0 or max_delay_s < min_delay_s:
            raise ValueError("need 0 < min_delay_s <= max_delay_s")
        self.quantile = float(quantile)
        self.min_delay_s = float(min_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.initial_delay_s = float(initial_delay_s)
        self.min_samples = int(min_samples)

    def delay_for(self, tracker: LatencyQuantiles, klass: str) -> float:
        if tracker.count(klass) < self.min_samples:
            delay = self.initial_delay_s
        else:
            delay = tracker.quantile(klass, self.quantile)
            if delay is None:
                # min_samples=0 with an empty window: there is no quantile
                # to trust yet — fall back like the cold-start path instead
                # of crashing the proxy handler on max(float, None)
                delay = self.initial_delay_s
        return min(self.max_delay_s, max(self.min_delay_s, delay))
