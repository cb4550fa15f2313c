"""Content-addressed explanation cache.

KernelSHAP is deterministic here by construction: the coalition plan is a
pure function of ``(M, nsamples, seed)`` and the solve runs in pinned-f32
on a fixed background, so two requests carrying the same instance rows
against the same fitted explainer produce byte-identical Explanation JSON.
Recomputing one is pure waste — at production traffic the same handful of
rows (dashboard entities, demo inputs, retried requests) dominates, and
every duplicate served from host memory is a device batch slot freed for a
novel request.

Keys are content-addressed: SHA-256 over the request's instance rows
(dtype + shape + bytes) combined with a *model fingerprint* — background
data digest, link, grouping, seed and the deployment's pinned
``explain_kwargs``.  Changing any of these (a refit on new background, a
different link, new grouping) changes the fingerprint, so stale entries
are unreachable rather than invalidated: eviction is purely LRU under a
byte budget.

The cache stores the exact JSON payload string the server would have sent,
so a hit is bit-identical to the original response — additivity and all.
"""

import hashlib
import logging
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
from torch import nn

logger = logging.getLogger(__name__)

# weak-fingerprint accounting (process-global, rendered via a registry
# callback like the explain-path counters): every model_fingerprint that
# had to fall back to in-process identity for its predictor — the
# stale-cache-across-restart hazard flagged since PR 2 — is counted here
# and warned about loudly ONCE per process instead of silently.
_weak_lock = threading.Lock()
_weak_count = 0
_weak_warned = False


def record_weak_fingerprint(predictor) -> None:
    global _weak_count, _weak_warned
    with _weak_lock:
        _weak_count += 1
        first = not _weak_warned
        _weak_warned = True
    if first:
        logger.warning(
            "model fingerprint fell back to in-process identity for %s: "
            "cache keys will NOT survive a restart and an in-place "
            "predictor swap is undetectable.  Register the model through "
            "the ModelRegistry (content fingerprints) or pin "
            "model.fingerprint explicitly.  Counted in "
            "dks_result_cache_weak_fingerprint_total.",
            type(predictor).__name__)


def weak_fingerprint_total() -> float:
    with _weak_lock:
        return float(_weak_count)


def attach_weak_fingerprint_metric(registry) -> None:
    """Register ``dks_result_cache_weak_fingerprint_total`` on
    ``registry``: model fingerprints that fell back to in-process
    predictor identity (restart-unstable cache keys)."""

    registry.counter(
        "dks_result_cache_weak_fingerprint_total",
        "Model fingerprints derived from in-process predictor identity "
        "(id()) because the predictor exposed no hashable content — such "
        "cache keys do not survive a restart.  Registry-registered "
        "models always get content fingerprints and never count here.",
    ).set_function(weak_fingerprint_total)


def array_fingerprint(array: np.ndarray) -> str:
    """SHA-256 digest of an array's dtype, shape and contents."""

    a = np.ascontiguousarray(array)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _update_structured(h, value) -> None:
    """Feed ``value`` into the hash with full content: ``repr`` alone is
    unsafe for ndarrays (numpy elides the middle of large arrays with
    ``...``, so two groupings differing only in the elided region would
    collide) — arrays hash via :func:`array_fingerprint`, containers
    recurse, and everything else falls back to ``repr``."""

    if isinstance(value, np.ndarray):
        h.update(b"nd:")
        h.update(array_fingerprint(value).encode())
    elif isinstance(value, (list, tuple)):
        h.update(f"seq{len(value)}:".encode())
        for item in value:
            _update_structured(h, item)
    elif isinstance(value, dict):
        h.update(f"map{len(value)}:".encode())
        for key in sorted(value, key=repr):
            h.update(repr(key).encode())
            _update_structured(h, value[key])
    else:
        h.update(repr(value).encode())


def _is_array_like(value) -> bool:
    """Numpy/JAX arrays (anything exposing shape+dtype that numpy can
    materialise) — the content a predictor's fingerprint hashes."""

    return hasattr(value, "shape") and hasattr(value, "dtype") \
        and not np.isscalar(value)


def _hash_array(value, h) -> int:
    """Feed one array's digest into ``h``; returns 1 when it was hashed.  A
    torch tensor (the port's predictors keep their parameters as buffers,
    on the card too) is read back to the host first."""

    try:
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        h.update(array_fingerprint(np.asarray(value)).encode())
        return 1
    except Exception:
        return 0


def _collect_module(module: nn.Module, h, depth: int) -> int:
    """Feed an ``nn.Module``'s content into ``h``: its class name, its
    parameters and buffers, its child modules in registration order (the
    members of an ``nn.ModuleList`` / ``nn.ModuleDict`` at the container's
    own depth, so a composite's members count as one level down, as the
    reference's member lists do) and its plain attributes.  Nothing here
    reads ``n_outputs``."""

    h.update(f"module:{type(module).__qualname__}".encode())
    found = 0
    for kind in ("_parameters", "_buffers"):
        for name, t in module.__dict__.get(kind, {}).items():
            h.update(f"{kind}:{name}".encode())
            if t is not None:
                found += _hash_array(t, h)
    container = isinstance(module, (nn.ModuleList, nn.ModuleDict))
    for name, child in module.__dict__.get("_modules", {}).items():
        h.update(f"child:{name}".encode())
        if child is not None:
            found += _collect_content(child, h, depth if container else depth + 1)
    for key in sorted(module.__dict__):
        if key.startswith("_") or key == "training":
            continue
        h.update(repr(key).encode())
        found += _collect_content(module.__dict__[key], h, depth + 1)
    return found


def _collect_content(value, h, depth: int = 0) -> int:
    """Feed every array reachable from ``value`` (attr dicts, sequences,
    nested predictors and ``nn.Module`` children — bounded depth) into
    ``h``; returns how many arrays were hashed."""

    if depth > 4:
        return 0
    if value is None or isinstance(value, (str, bytes, bool, int, float)):
        # scalar config (activation names, out_transform, offsets, ...)
        # is part of the content — two predictors sharing arrays but
        # differing in a plain attribute must NOT collide — but scalars
        # alone do not make a fingerprint "content-based" (return 0):
        # without parameter arrays the id() fallback still applies
        h.update(repr(value).encode())
        return 0
    if _is_array_like(value):
        return _hash_array(value, h)
    if isinstance(value, nn.Module):
        # composites keep their members in nn.ModuleList children, which
        # carry no n_outputs: walk modules structurally
        return _collect_module(value, h, depth)
    if isinstance(value, (list, tuple)):
        return sum(_collect_content(v, h, depth + 1) for v in value)
    if isinstance(value, dict):
        found = 0
        for k in sorted(value, key=repr):
            h.update(repr(k).encode())
            found += _collect_content(value[k], h, depth + 1)
        return found
    attrs = getattr(value, "__dict__", None)
    if attrs is not None and depth < 4 and hasattr(value, "n_outputs"):
        # nested predictors (composite lifts hold member predictors)
        found = 0
        for key in sorted(attrs):
            h.update(repr(key).encode())
            found += _collect_content(attrs[key], h, depth + 1)
        return found
    return 0


def predictor_fingerprint(predictor) -> Tuple[str, bool]:
    """``(digest, weak)`` for a predictor: a content hash over its class
    name and every parameter array reachable from its attributes
    (coefficients, tree tensors, TT cores, MLP layers — stable across
    restarts and across distinct-but-identical objects), or — when no
    array content is reachable (host callbacks, stub models) — the
    historical in-process identity with ``weak=True``."""

    h = hashlib.sha256()
    h.update(type(predictor).__qualname__.encode())
    # predictors that publish their own content bytes (TT cores, lifted
    # neural graphs, param-carrying JaxPredictors) are authoritative:
    # the declared bytes ARE the deployment identity (None means the
    # predictor has no content — fall through to introspection)
    fp_bytes = getattr(predictor, "fingerprint_bytes", None)
    if callable(fp_bytes):
        try:
            declared = fp_bytes()
        except Exception:
            declared = None
        if declared is not None:
            h.update(declared)
            return h.hexdigest(), False
    found = _collect_content(getattr(predictor, "__dict__", None) or {}, h)
    if found:
        return h.hexdigest(), False
    return (f"{type(predictor).__qualname__}:{id(predictor)}", True)


def model_fingerprint(model, explain_kwargs: Optional[dict] = None,
                      count_weak: bool = True) -> str:
    """Fingerprint of everything besides the instance rows that determines
    an explanation: background digest, link, grouping, seed, pinned explain
    options and the predictor's in-process identity.

    A model may pin its own ``fingerprint`` attribute (the registry does —
    ``model_id@vN:<content digest>`` — so restarts share keys); otherwise
    the fingerprint is derived by introspection.  Predictor identity is a
    CONTENT hash of its parameter arrays when any are reachable
    (:func:`predictor_fingerprint`); only parameterless predictors (host
    callbacks, stubs) fall back to ``id(predictor)`` — correct within one
    process (a different object can only cause misses, never wrong
    answers) but restart-unstable, so the fallback is counted in
    ``dks_result_cache_weak_fingerprint_total`` and warned about once.
    """

    explicit = getattr(model, "fingerprint", None)
    if isinstance(explicit, str) and explicit:
        return explicit
    h = hashlib.sha256()
    explainer = getattr(model, "explainer", model)
    engine = getattr(explainer, "_explainer", None)
    background = getattr(engine, "background", None)
    if background is not None:
        h.update(array_fingerprint(np.asarray(background)).encode())
    bg_weights = getattr(engine, "bg_weights", None)
    if bg_weights is not None:
        h.update(array_fingerprint(np.asarray(bg_weights)).encode())
    h.update(repr(getattr(explainer, "link", None)).encode())
    h.update(repr(getattr(explainer, "seed", None)).encode())
    _update_structured(h, getattr(engine, "groups", None))
    kwargs = (explain_kwargs if explain_kwargs is not None
              else getattr(model, "explain_kwargs", None))
    _update_structured(h, kwargs or {})
    predictor = getattr(engine, "predictor",
                        getattr(explainer, "predictor", None))
    digest, weak = predictor_fingerprint(predictor)
    if weak and count_weak:
        # count_weak=False is the registry's ingest path: it namespaces
        # the digest under a declared (model_id, version), so even a
        # parameterless predictor's keys are restart-stable
        record_weak_fingerprint(predictor)
    h.update(digest.encode())
    return h.hexdigest()


def request_cache_key(array: np.ndarray, model_fp: str) -> str:
    """Key for one request: instance-rows digest x model fingerprint."""

    return f"{model_fp}:{array_fingerprint(array)}"


class ResultCache:
    """Thread-safe LRU cache of response payload strings, bounded by an
    approximate byte budget (UTF-8 length of the stored payloads; the JSON
    here is ASCII so ``len(payload)`` is the byte count).

    Entries carry a *fidelity*: the reported error bound of the stored
    payload (``est_err``, 0.0 = full fidelity — every pre-anytime payload).
    One content key stores the HIGHEST-fidelity payload seen (a coarser
    anytime answer never overwrites a finer one), and a lookup only hits
    when the stored fidelity satisfies the caller's error budget —
    budget-less callers (``max_err=None``) are served full-fidelity
    entries only, which is exactly the historical behaviour."""

    def __init__(self, max_bytes: int, mem_account=None):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive "
                             "(use no cache instead of a zero-byte one)")
        self.max_bytes = int(max_bytes)
        # key -> (payload, est_err)
        self._entries: "OrderedDict[str, Tuple[str, float]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._audit_rejects = 0
        # optional memory-ledger account: payload bytes are host memory,
        # but they hold device work hostage (a hit IS a device batch slot
        # freed), so the ledger tracks them under owner=result_cache next
        # to the true device buffers.  Charges are namespaced by this
        # cache instance — several servers may share one process account.
        self._mem = mem_account
        self._mem_token = object()

    def _mem_charge(self, key: str, size: int) -> None:
        if self._mem is not None:
            self._mem.charge((self._mem_token, key), size, sweep=False)

    def _mem_release(self, key: str) -> None:
        if self._mem is not None:
            self._mem.release((self._mem_token, key))

    def get(self, key: str,
            max_err: Optional[float] = None) -> Optional[str]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            payload, est_err = entry
            if est_err > (0.0 if max_err is None else max_err):
                # stored answer is coarser than this caller tolerates:
                # a fidelity miss costs device work like a cold miss
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return payload

    def put(self, key: str, payload: str, est_err: float = 0.0,
            screened: bool = False) -> None:
        """Insert (keep-best).  ``screened=True`` means the quality
        invariant screen is the caller's responsibility (the server
        queues every finalized answer for its deferred audit and
        ``invalidate``\\ s any entry whose payload fails it); unscreened
        callers pay the screen here — a phi payload violating
        additivity/finiteness must never become a bit-identical repeat
        offender (audit-on-insert, ``observability/quality.py``)."""

        size = len(payload)
        if size > self.max_bytes:
            return  # larger than the whole budget: caching it evicts all
        est_err = max(0.0, float(est_err))
        if not screened:
            from distributedkernelshap_tpu_torch.observability.quality import (
                cacheable_payload,
            )

            if not cacheable_payload(payload, final_err=est_err):
                with self._lock:
                    self._audit_rejects += 1
                return
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                if old[1] < est_err:
                    # keep-best: the stored payload is strictly finer;
                    # equal fidelity replaces (historical last-write-wins)
                    self._entries.move_to_end(key)
                    return
                self._entries.pop(key)
                self._bytes -= len(old[0])
                self._mem_release(key)
            self._entries[key] = (payload, est_err)
            self._bytes += size
            self._mem_charge(key, size)
            while self._bytes > self.max_bytes and self._entries:
                ev_key, (evicted, _err) = self._entries.popitem(last=False)
                self._bytes -= len(evicted)
                self._evictions += 1
                self._mem_release(ev_key)
        if self._mem is not None:
            # the ledger's pressure sweep re-enters this cache through
            # evict_bytes, so it must run with our lock released
            self._mem.ledger.poke()

    def invalidate(self, key: str, audit: bool = False) -> bool:
        """Remove one entry outright.  ``audit=True`` is the deferred
        quality audit's poison-removal hook: the server inserts at
        finalize time (keeping the hot path lock-free of the screen) and
        the audit thread pulls the entry back out if the payload fails
        the invariant screen — counted with the insert-time rejects in
        ``audit_rejects``."""

        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._bytes -= len(entry[0])
            self._mem_release(key)
            if audit:
                self._audit_rejects += 1
        return True

    def evict_bytes(self, nbytes: int) -> int:
        """LRU-evict until at least ``nbytes`` are freed (or the cache
        is empty); the memory ledger's pressure hook.  Evicted answers
        recompute bit-identically on the next request — content-
        addressed keys make eviction always safe."""

        freed = 0
        with self._lock:
            while self._entries and freed < int(nbytes):
                key, (payload, _err) = self._entries.popitem(last=False)
                self._bytes -= len(payload)
                self._evictions += 1
                freed += len(payload)
                self._mem_release(key)
        return freed

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def current_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "audit_rejects": self._audit_rejects,
                    "entries": len(self._entries), "bytes": self._bytes}
