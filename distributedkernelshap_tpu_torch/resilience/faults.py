"""Deterministic, seedable fault injection for the serving and pool paths.

Chaos tests are only worth their runtime if they drive the REAL failure
handling — the proxy's 502/504 paths, the supervisor's restart loop, the
journal's resume — so faults are injected at named *sites* inside the
production code (``serving/server.py``, ``parallel/pipeline.py``) rather
than by mocking the components around them.  Every fault is deterministic
given its spec: triggers are hit-counted (``after=N`` skips the first N
hits at the site) and probabilistic triggers draw from a spec-owned
``random.Random(seed)``, so a chaos scenario replays identically.

Spec grammar (``DKS_FAULTS`` env var, ``;``-separated)::

    kind:site=SITE[,after=N][,times=M][,p=F][,seed=S][,delay=SECONDS]
        [,replica=K]

with ``kind`` one of:

``crash``
    ``os._exit(42)`` — the process dies mid-request exactly like a
    SIGKILLed replica (no atexit, no flush).
``hang``
    sleep ``delay`` seconds (default 3600) — a wedged device relay: the
    socket stays open, nothing answers, only timeouts/watchdogs fire.
``slow``
    sleep ``delay`` seconds (default 0.5) then continue — a straggler.
``drop``
    returned to the caller, which closes the connection without replying
    (mid-request connection loss as seen by the client/proxy).
``corrupt``
    returned to the caller, which garbles the response payload before
    sending (bit-rot / truncated-write on the wire).

``after=N``
    skip the first N hits at the site; fire from hit N+1 on.
``times=M``
    fire at most M times (default unlimited).
``p=F``
    once armed, fire with probability F per hit (seeded; default 1.0).
``replica=K``
    only active in the worker whose ``DKS_REPLICA_INDEX`` env equals K —
    one fleet-wide ``DKS_FAULTS`` value can script per-replica behaviour.

Sites currently consulted:

``server.accept``
    ``ExplainerServer``'s handler, after the body parses and before
    admission (crash/hang/slow before any device work).
``server.explain``
    just before the success response is sent (crash/hang/slow/drop/
    corrupt after the device computed — the worst case for lost work).
``pool.shard``
    ``parallel/pipeline.run_pipeline`` on JOURNALED slab loops only,
    after a shard's fetch completes and BEFORE it is journaled —
    ``crash:site=pool.shard,after=K`` kills a batch run with exactly one
    fetched-but-unjournaled shard, the shard a resume must recompute.
    Non-journaled pipelines (the engine's internal chunk loops, serving)
    never consult it, so the hit count stays a pure shard counter.
``scaler.tick``
    ``serving/autoscaler.Autoscaler``'s control loop, at the top of each
    evaluation tick.  The scaler is a control thread inside the fleet's
    parent process, so ``crash`` here is THREAD-scoped (the scaler calls
    :meth:`FaultInjector.fire` with ``crash_scope="thread"``): the fired
    crash is returned to the caller, which kills the scaler loop and
    nothing else — a whole-process ``os._exit`` would take the fan-in
    proxy and every client connection with it, which is a different
    fault (process death) the other sites already script.  ``hang``
    wedges the tick thread.  Either way the fleet must degrade to its
    CURRENT size and keep serving (never drain to zero) — the invariant
    ``chaos_bench.py --check`` asserts.
``engine.phi``
    ``ExplainerServer._complete``, after the engine's answer payload is
    assigned and BEFORE the quality audit / result-cache insert.
    ``corrupt`` here is a *numeric* fault, not a wire fault: the
    cooperating call site rewrites the payload through
    :func:`corrupt_phi_payload` — the document still parses, the phi
    values inside are wrong (one attribution perturbed, seeded by the
    site's hit count).  This is the "device computed a wrong answer"
    drill the transport-level ``server.explain`` corrupt cannot script,
    and the true-positive arm of ``benchmarks/quality_bench.py
    --check``: the in-band invariant auditor must flag it.
"""

import json
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

KINDS = ("crash", "hang", "slow", "drop", "corrupt")

#: default sleep per kind when the spec carries no ``delay=``
_DEFAULT_DELAY_S = {"hang": 3600.0, "slow": 0.5}

#: exit code used by ``crash`` so tests/benchmarks can tell an injected
#: crash from an organic one
CRASH_EXIT_CODE = 42


class FaultSpec:
    """One parsed fault clause (see module doc for the grammar)."""

    def __init__(self, kind: str, site: str, after: int = 0,
                 times: Optional[int] = None, p: float = 1.0,
                 seed: int = 0, delay_s: Optional[float] = None,
                 replica: Optional[int] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"expected one of {KINDS}")
        if not site:
            raise ValueError("a fault spec needs site=...")
        if after < 0:
            raise ValueError("after= must be >= 0")
        if times is not None and times < 1:
            raise ValueError("times= must be >= 1")
        if not 0.0 <= p <= 1.0:
            raise ValueError("p= must be in [0, 1]")
        self.kind = kind
        self.site = site
        self.after = int(after)
        self.times = times
        self.p = float(p)
        self.seed = int(seed)
        self.delay_s = (float(delay_s) if delay_s is not None
                        else _DEFAULT_DELAY_S.get(kind, 0.0))
        self.replica = replica
        # per-spec state: hit counter and a private RNG so the fire
        # sequence is a pure function of (spec, hit order)
        self._hits = 0
        self._fired = 0
        self._rng = random.Random(self.seed)

    def __repr__(self):
        return (f"FaultSpec({self.kind}:site={self.site},after={self.after},"
                f"times={self.times},p={self.p},delay={self.delay_s},"
                f"replica={self.replica})")


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse a ``DKS_FAULTS`` value into specs; raises ``ValueError`` on a
    malformed clause (a chaos run with a silently-dropped fault would
    pass for the wrong reason)."""

    specs = []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, rest = clause.partition(":")
        kind = kind.strip()
        fields: Dict[str, str] = {}
        for part in rest.split(","):
            part = part.strip()
            if not part:
                continue
            key, eq, value = part.partition("=")
            if not eq:
                raise ValueError(f"bad fault field {part!r} in {clause!r}")
            fields[key.strip()] = value.strip()
        unknown = set(fields) - {"site", "after", "times", "p", "seed",
                                 "delay", "replica"}
        if unknown:
            raise ValueError(f"unknown fault fields {sorted(unknown)} "
                             f"in {clause!r}")
        specs.append(FaultSpec(
            kind,
            fields.get("site", ""),
            after=int(fields.get("after", 0)),
            times=int(fields["times"]) if "times" in fields else None,
            p=float(fields.get("p", 1.0)),
            seed=int(fields.get("seed", 0)),
            delay_s=float(fields["delay"]) if "delay" in fields else None,
            replica=int(fields["replica"]) if "replica" in fields else None,
        ))
    return specs


class FaultInjector:
    """Evaluates fault specs at injection sites.

    ``fire(site)`` performs in-process faults (crash exits, hang/slow
    sleep) and returns the fault *kind* for faults that need caller
    cooperation (``drop``, ``corrupt``) — the call site interprets those.
    Returns ``None`` when nothing fires.  Thread-safe: hit counting is
    locked so concurrent handler threads see one global hit order (the
    order itself is scheduling-dependent under concurrency; deterministic
    scenarios use single-threaded sites or ``after=`` counts larger than
    the concurrency window).
    """

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._lock = threading.Lock()

    def _decide(self, site: str) -> Optional[FaultSpec]:
        with self._lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                spec._hits += 1
                if spec._hits <= spec.after:
                    continue
                if spec.times is not None and spec._fired >= spec.times:
                    continue
                if spec.p < 1.0 and spec._rng.random() >= spec.p:
                    continue
                spec._fired += 1
                return spec
        return None

    def fire(self, site: str, crash_scope: str = "process") -> Optional[str]:
        """Evaluate ``site``; see the class doc.  ``crash_scope`` selects
        what a fired ``crash`` kills: ``"process"`` (default — the
        historical ``os._exit``) or ``"thread"``, where ``"crash"`` is
        RETURNED and the caller owns dying — used by control loops (the
        autoscaler's ``scaler.tick``) whose death must not take the
        serving process with them."""

        spec = self._decide(site)
        if spec is None:
            return None
        logger.warning("fault injection: firing %s at site %s",
                       spec.kind, site)
        # the flight recorder is the chaos run's shared timeline: every
        # fired fault lands on it, and a crash dumps the whole ring to
        # $DKS_FLIGHTREC_DIR before the process dies — one artifact
        # instead of log archaeology.  Imported lazily: faults must parse
        # specs at worker startup before anything heavier loads.
        from distributedkernelshap_tpu_torch.observability.flightrec import (
            flightrec,
        )

        flightrec().record("fault_injected", fault=spec.kind, site=site,
                           delay_s=spec.delay_s)
        if spec.kind == "crash":
            if crash_scope == "thread":
                # the caller kills ITS OWN loop; the process (proxy,
                # replicas, client sockets) lives on
                return spec.kind
            # the dump happens HERE because nothing after os._exit does:
            # no atexit, no flush — an injected crash is the one fault
            # that can still leave its black box behind
            flightrec().dump_crash(reason=f"injected crash at {site}")
            # os._exit, not sys.exit: a real crash skips atexit handlers,
            # response flushing, everything — that is the point
            os._exit(CRASH_EXIT_CODE)
        if spec.kind in ("hang", "slow"):
            time.sleep(spec.delay_s)
            return spec.kind
        return spec.kind  # drop / corrupt: caller cooperates

    def hits(self, site: str) -> int:
        with self._lock:
            return sum(s._hits for s in self.specs if s.site == site)


def corrupt_payload(payload: bytes) -> bytes:
    """Deterministically garble a response payload: overwrite the middle
    with bytes that cannot parse as JSON, keeping the length (so
    ``Content-Length`` framing stays intact and the corruption is a
    payload-level fault, not a framing fault)."""

    marker = b"\xffCORRUPTED\xff"
    if len(payload) <= len(marker):
        return marker[:len(payload)]
    mid = (len(payload) - len(marker)) // 2
    return payload[:mid] + marker + payload[mid + len(marker):]


def corrupt_phi_payload(payload, seed: int = 0):
    """Numerically corrupt one served explanation payload (the
    ``engine.phi`` site's cooperating rewrite): decode it, add a large
    deterministic delta to one phi entry — chosen by ``seed``, normally
    the site's hit count — and re-encode in the SAME wire format.  The
    result still parses and still frames; only the additivity invariant
    is broken, which is exactly what a silent device numeric fault looks
    like.  Payloads that cannot be decoded are returned unchanged (the
    drill needs a parsable-but-wrong answer, not a transport fault)."""

    import numpy as np

    from distributedkernelshap_tpu_torch.serving import wire

    binary = isinstance(payload, (bytes, bytearray))
    try:
        if binary:
            arrays = wire.decode_explanation(bytes(payload))
        else:
            doc = json.loads(payload)
            arrays = wire.explanation_payload_from_json(payload)
    except Exception:  # noqa: BLE001 — leave undecodable payloads alone
        return payload
    sv = [np.array(v, dtype=np.float64)
          for v in arrays["shap_values"]]
    if not sv or not sv[0].size:
        return payload
    rng = random.Random(seed)
    k = rng.randrange(len(sv))
    flat = sv[k].reshape(-1)
    flat[rng.randrange(flat.shape[0])] += 10.0 + rng.random()
    if binary:
        return wire.encode_explanation(
            sv, np.asarray(arrays["expected_value"]),
            np.asarray(arrays["raw_prediction"]),
            interaction_values=arrays.get("interaction_values"))
    doc["data"]["shap_values"] = [v.tolist() for v in sv]
    return json.dumps(doc)


def from_env(env: Optional[Dict[str, str]] = None) -> Optional[FaultInjector]:
    """Build an injector from ``DKS_FAULTS``; ``None`` when unset/empty.

    Specs carrying ``replica=K`` are kept only when this process's
    ``DKS_REPLICA_INDEX`` matches, so one fleet-wide env value scripts
    per-replica behaviour (slow replica 2, crash replica 0, ...).
    """

    env = os.environ if env is None else env
    text = env.get("DKS_FAULTS", "").strip()
    if not text:
        return None
    specs = parse_faults(text)
    index = env.get("DKS_REPLICA_INDEX")
    kept = [s for s in specs
            if s.replica is None
            or (index is not None and int(index) == s.replica)]
    if not kept:
        return None
    logger.warning("fault injection active: %s", kept)
    return FaultInjector(kept)


_env_injector_cache: List = []  # [Optional[FaultInjector]] once resolved


def env_injector() -> Optional[FaultInjector]:
    """Process-wide injector resolved from the environment ONCE (hit
    counters must persist across call sites; re-parsing per call would
    reset them).  Tests monkeypatch this or use :func:`from_env`."""

    if not _env_injector_cache:
        _env_injector_cache.append(from_env())
    return _env_injector_cache[0]
