"""Device-memory ledger: every owner of live device bytes opens an
account.

Port of ``distributedkernelshap_tpu/observability/memledger.py`` with two
changes: :class:`TrackedCache` releases the charge of every removal
(``pop``, ``popitem`` and ``evict_bytes`` included — CPython's C
``OrderedDict`` does not route those through a subclass's
``__delitem__``, so the reference's copy leaks their charges), and
:meth:`MemLedger.reconcile` reads the CUDA caching allocator
(``torch.cuda.memory_stats``) of the device the engines charge from.

The fleet can attribute every device-*second* to a tenant (costmeter),
but device *bytes* had no observer: six content-fingerprint LRU device
caches (``_dev_cache``, linear plan consts, ``_exact_consts``,
``_exact_reach_full``, ``_exact_tn_consts``, ``_deepshap_consts``, the
anytime consts), the byte-budget result cache, staged batch buffers and
the anytime keep-best entries each bound themselves *locally*, so a
multi-tenant host discovered memory exhaustion by dying.  The
:class:`MemLedger` is the process-wide ledger those owners charge and
release against on every insert/evict, labeled ``{owner, model,
version, path}``, so "total live device bytes per tenant" becomes one
gauge (``dks_device_bytes{owner,model}``) next to the cost plane's
device-seconds.

Bytes are COMPUTED (sum of ``.nbytes`` over the charged value's array
leaves), not measured: the ledger never touches the device.  When the
engines run on a CUDA device (:meth:`MemLedger.note_device`),
:meth:`reconcile` reports the gap between the caching allocator's
``allocated_bytes.all.current`` and the ledger's computed total
(``dks_mem_reconcile_gap_bytes``); on the CPU there are no allocator
stats, so there the ledger is computed-bytes-only by design (the gap
renders as 0 with ``supported: false`` in the ``/statusz`` memory
panel).

**Pressure contract**: a configurable soft budget
(``DKS_MEM_BUDGET_BYTES`` / :meth:`set_budget`; 0 = unlimited).  A
charge that lifts the total above the budget emits ONE
``memory_pressure`` flight event and invokes the registered pressure
callbacks (result-cache byte eviction, LRU shrink of every tracked
device cache — largest account first) until the total is back under the
threshold or nothing more can be freed.  Eviction only ever forces
recompute: served answers stay bit-identical, because every evictable
buffer is a pure function of fingerprinted content.  A
:class:`TrackedCache` never evicts its most-recently-used entry, so the
engine's check-then-read lookup pattern cannot lose the entry it just
touched to a concurrent pressure sweep.

Stdlib-only (the observability package contract): array bytes are read
via duck-typed ``.nbytes`` (numpy arrays and torch tensors both have
it); ``torch`` is imported lazily inside :meth:`reconcile` only.
"""

import logging
import os
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from distributedkernelshap_tpu_torch.analysis.lockwitness import (
    make_lock,
    make_rlock,
)

logger = logging.getLogger(__name__)

#: label value rendered for charges that carry no model id (engines used
#: outside the registry) — mirrors the costmeter's default tenant
DEFAULT_MODEL_LABEL = "default"

#: bounded recursion when computing nbytes over nested containers
_NBYTES_MAX_DEPTH = 6


def resolve_mem_ledger_env(default: bool = True) -> bool:
    """``DKS_MEM_LEDGER=0`` disables the ledger (charges become no-ops;
    the metric families still register so the catalog is mode-
    independent, mirroring the costmeter's escape hatch)."""

    raw = os.environ.get("DKS_MEM_LEDGER")
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in ("0", "false", "off", "no")


def resolve_mem_budget_env(default: int = 0) -> int:
    """``DKS_MEM_BUDGET_BYTES`` — soft budget in bytes (0 = unlimited).
    Garbage parses as the default, loudly."""

    raw = os.environ.get("DKS_MEM_BUDGET_BYTES")
    if raw is None or raw.strip() == "":
        return default
    try:
        return max(0, int(float(raw.strip())))
    except ValueError:
        logger.warning("DKS_MEM_BUDGET_BYTES=%r is not a number; "
                       "using %d", raw, default)
        return default


def approx_nbytes(value, _depth: int = 0) -> int:
    """Computed bytes of ``value``: sum of ``.nbytes`` over every array
    leaf reachable through tuples/lists/dicts (numpy arrays and torch
    tensors both expose ``.nbytes`` — no torch import needed).  Non-array scalars and
    opaque objects count 0; recursion is depth-bounded."""

    if value is None or _depth > _NBYTES_MAX_DEPTH:
        return 0
    n = getattr(value, "nbytes", None)
    if n is not None:
        try:
            return int(n)
        except (TypeError, ValueError):
            return 0
    if isinstance(value, dict):
        return sum(approx_nbytes(v, _depth + 1) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(approx_nbytes(v, _depth + 1) for v in value)
    if isinstance(value, (str, bytes)):
        return len(value)
    return 0


class Account:
    """One owner's view into the ledger: a labeled bag of per-key byte
    charges.  All bookkeeping happens under the ledger's lock; the
    account itself is just the label tuple plus its charge map."""

    __slots__ = ("ledger", "owner", "model", "version", "path",
                 "_charges", "_total", "__weakref__")

    def __init__(self, ledger: "MemLedger", owner: str,
                 model: Optional[str], version: Optional[int],
                 path: Optional[str]):
        self.ledger = ledger
        self.owner = owner
        self.model = model
        self.version = version
        self.path = path
        self._charges: Dict = {}
        self._total = 0

    def charge(self, key, nbytes: int, sweep: bool = True) -> None:
        """Record ``nbytes`` live bytes under ``key`` (replacing any
        prior charge for the key).  May trigger the pressure sweep —
        callers charging while holding their own container lock pass
        ``sweep=False`` and call :meth:`MemLedger.poke` after releasing
        it (the sweep re-enters containers to evict)."""

        self.ledger._charge(self, key, int(nbytes), sweep=sweep)

    def release(self, key) -> int:
        """Drop the charge for ``key``; returns the bytes released
        (0 when the key was never charged or was already retired)."""

        return self.ledger._release(self, key)

    def clear(self) -> int:
        """Release every charge; returns the bytes released."""

        return self.ledger._clear_account(self)

    @property
    def total_bytes(self) -> int:
        return self._total


class TrackedCache(OrderedDict):
    """An ``OrderedDict`` LRU that mirrors every mutation into ledger
    accounts — drop-in for the engine's device caches so the existing
    insert/evict sites (``cache[k] = v`` + ``popitem(last=False)``)
    charge and release without being touched.

    ``owner_for_key`` routes heterogenous caches (the plan-consts cache
    holds linear/exact/tensor-network/deepshap/anytime constants under
    distinct key shapes) to per-owner accounts.  ``rebind`` relabels the
    live charges when the registry later learns the tenant.  Mutations
    are serialized by an internal lock so a pressure sweep on another
    thread cannot interleave with the owning thread's insert."""

    def __init__(self, ledger: "MemLedger", owner: str,
                 nbytes_fn: Callable = approx_nbytes,
                 owner_for_key: Optional[Callable] = None,
                 model: Optional[str] = None,
                 version: Optional[int] = None,
                 path: Optional[str] = None):
        super().__init__()
        self._ledger = ledger
        self._owner = owner
        self._nbytes_fn = nbytes_fn
        self._owner_for_key = owner_for_key
        self._labels = {"model": model, "version": version, "path": path}
        # charge keys are namespaced by a per-cache token: two caches
        # sharing an account (same owner+model) must not collide on
        # equal cache keys
        self._token = object()
        # cache key -> (account, ledger charge key, nbytes)
        self._charged: Dict = {}
        # reentrant: a pressure sweep may re-enter a cache whose owner
        # thread already holds the lock (evict_bytes -> popitem)
        self._tc_lock = make_rlock("memledger.tracked_cache")
        ledger._track(self)
        # release this cache's live charges when the owning engine is
        # garbage collected (unregistered-tenant engines never get an
        # explicit retire); the finalizer must not strongly reference
        # the cache itself
        weakref.finalize(self, ledger._purge_charges, self._charged)

    # -- ledger plumbing ------------------------------------------------

    def _account_for(self, key) -> Account:
        owner = (self._owner_for_key(key) if self._owner_for_key
                 else self._owner)
        return self._ledger.account(owner, **self._labels)

    def _charge_key(self, key, value) -> None:
        if not self._ledger.enabled:
            return
        acct = self._account_for(key)
        n = int(self._nbytes_fn(value))
        ck = (self._token, key)
        self._charged[key] = (acct, ck, n)
        acct.charge(ck, n, sweep=False)

    def _release_key(self, key) -> None:
        entry = self._charged.pop(key, None)
        if entry is not None:
            entry[0].release(entry[1])

    @property
    def ledger_bytes(self) -> int:
        """This cache's own view of its live charged bytes."""

        with self._tc_lock:
            return sum(n for _, _, n in self._charged.values())

    def rebind(self, model: Optional[str] = None,
               version: Optional[int] = None,
               path: Optional[str] = None) -> None:
        """Relabel live charges (the registry calls this when a model
        built before registration gains its tenant identity)."""

        with self._tc_lock:
            self._labels = {"model": model, "version": version,
                            "path": path}
            for key in list(self._charged):
                acct, ck, n = self._charged[key]
                acct.release(ck)
                fresh = self._account_for(key)
                self._charged[key] = (fresh, ck, n)
                fresh.charge(ck, n, sweep=False)

    def evict_bytes(self, nbytes: int) -> int:
        """LRU-evict until at least ``nbytes`` are freed, but never the
        most-recently-used entry (see module doc).  Returns freed."""

        freed = 0
        with self._tc_lock:
            while len(self) > 1 and freed < nbytes:
                key = next(iter(self))
                entry = self._charged.get(key)
                n = entry[2] if entry is not None else 0
                # OrderedDict.popitem does not call __delitem__: release
                # the evicted entry's charge here
                OrderedDict.popitem(self, last=False)
                self._release_key(key)
                freed += n
        return freed

    # -- mutation overrides.  CPython's C ``OrderedDict`` does NOT route
    # ``pop`` or ``popitem`` through a subclass's ``__delitem__`` (only
    # ``del`` reaches it), and ``clear`` bypasses both ``__delitem__``
    # and ``__setitem__``: each gets its own wrapper that releases the
    # charge.  ``update`` dispatches through ``__setitem__``;
    # ``setdefault`` does today, but is wrapped as well so that a
    # charge never depends on that detail. ------------------------------

    def __setitem__(self, key, value):
        with self._tc_lock:
            self._release_key(key)
            OrderedDict.__setitem__(self, key, value)
            self._charge_key(key, value)
        # the pressure sweep re-enters tracked caches to evict, so it
        # must run with this cache's lock released
        self._ledger.poke()

    def __delitem__(self, key):
        with self._tc_lock:
            OrderedDict.__delitem__(self, key)
            self._release_key(key)

    _MISSING = object()

    def pop(self, key, default=_MISSING):
        with self._tc_lock:
            if key in self:
                value = OrderedDict.pop(self, key)
                self._release_key(key)
                return value
            if default is TrackedCache._MISSING:
                raise KeyError(key)
            return default

    def popitem(self, last: bool = True):
        with self._tc_lock:
            key, value = OrderedDict.popitem(self, last=last)
            self._release_key(key)
            return key, value

    def setdefault(self, key, default=None):
        with self._tc_lock:
            if key in self:
                return OrderedDict.__getitem__(self, key)
            self.__setitem__(key, default)
            return default

    def clear(self):
        with self._tc_lock:
            OrderedDict.clear(self)
            for key in list(self._charged):
                self._release_key(key)


class MemLedger:
    """Process-wide device-byte ledger (see module doc).  Thread-safe;
    all totals are integers of computed bytes."""

    def __init__(self, enabled: Optional[bool] = None,
                 budget_bytes: Optional[int] = None):
        self.enabled = (resolve_mem_ledger_env() if enabled is None
                        else bool(enabled))
        self._budget = (resolve_mem_budget_env() if budget_bytes is None
                        else max(0, int(budget_bytes)))
        self._lock = make_lock("memledger.accounts")
        self._accounts: Dict[Tuple, Account] = {}
        # id -> weakref (dict subclasses are unhashable, so no WeakSet)
        self._caches: Dict[int, weakref.ref] = {}
        self._pressure_cbs: List = []  # WeakMethod | callable
        self._total = 0
        self._high_water = 0
        self._pressure_events = 0
        self._evicted_bytes = 0
        self._last_gap: Optional[int] = None
        self._in_pressure = threading.local()
        # the CUDA device the engines' charges live on (note_device)
        self._device = None

    # -- accounts -------------------------------------------------------

    def account(self, owner: str, model: Optional[str] = None,
                version: Optional[int] = None,
                path: Optional[str] = None) -> Account:
        """The (owner, model, version, path) account, created on first
        use.  Accounts are interned: same labels, same object."""

        key = (str(owner), model, version, path)
        with self._lock:
            acct = self._accounts.get(key)
            if acct is None:
                acct = self._accounts[key] = Account(
                    self, str(owner), model, version, path)
            return acct

    def tracked_cache(self, owner: str,
                      nbytes_fn: Callable = approx_nbytes,
                      owner_for_key: Optional[Callable] = None,
                      model: Optional[str] = None,
                      version: Optional[int] = None,
                      path: Optional[str] = None) -> TrackedCache:
        """A ledger-mirroring :class:`TrackedCache` enrolled in the
        pressure sweep."""

        return TrackedCache(self, owner, nbytes_fn=nbytes_fn,
                            owner_for_key=owner_for_key, model=model,
                            version=version, path=path)

    def _track(self, cache: TrackedCache) -> None:
        with self._lock:
            # opportunistic prune: dead refs leave with the next track
            # or pressure sweep (a GC-time callback could fire while
            # the ledger lock is held — not worth the deadlock risk)
            for token in [t for t, r in self._caches.items()
                          if r() is None]:
                self._caches.pop(token, None)
            self._caches[id(cache)] = weakref.ref(cache)

    # -- charge/release core -------------------------------------------

    def _charge(self, acct: Account, key, nbytes: int,
                sweep: bool = True) -> None:
        if not self.enabled:
            return
        nbytes = max(0, int(nbytes))
        with self._lock:
            old = acct._charges.pop(key, 0)
            acct._charges[key] = nbytes
            delta = nbytes - old
            acct._total += delta
            self._total += delta
            if self._total > self._high_water:
                self._high_water = self._total
            over = (self._total - self._budget) if self._budget else 0
        if sweep and over > 0:
            self._pressure(over)

    def poke(self) -> None:
        """Run the pressure sweep if over budget — for callers that
        charged with ``sweep=False`` under their own lock."""

        if not self.enabled or not self._budget:
            return
        over = self.overage_bytes()
        if over > 0:
            self._pressure(over)

    def _release(self, acct: Account, key) -> int:
        if not self.enabled:
            return 0
        with self._lock:
            n = acct._charges.pop(key, 0)
            acct._total -= n
            self._total -= n
            return n

    def _clear_account(self, acct: Account) -> int:
        if not self.enabled:
            return 0
        with self._lock:
            n = acct._total
            acct._charges.clear()
            acct._total = 0
            self._total -= n
            return n

    def _purge_charges(self, charged: Dict) -> None:
        """Finalizer for a dead :class:`TrackedCache`: release whatever
        it still had charged (best-effort — interpreter shutdown may
        have torn pieces down)."""

        try:
            for key, (acct, ck, _n) in list(charged.items()):
                acct.release(ck)
            charged.clear()
        except Exception:  # pragma: no cover - shutdown races
            return

    # -- budget & pressure ----------------------------------------------

    @property
    def budget_bytes(self) -> int:
        return self._budget

    def set_budget(self, nbytes: int) -> None:
        self._budget = max(0, int(nbytes))

    def register_pressure_callback(self, cb: Callable[[int], int]) -> None:
        """Register ``cb(overage_bytes) -> freed_bytes``.  Bound methods
        are held weakly (a stopped server's result cache must not be
        kept alive by the process ledger); plain callables strongly."""

        try:
            ref = weakref.WeakMethod(cb)
        except TypeError:
            ref = None
        with self._lock:
            self._pressure_cbs.append(ref if ref is not None else cb)

    def overage_bytes(self) -> int:
        with self._lock:
            return (self._total - self._budget) if self._budget else 0

    def _pressure(self, overage: int) -> None:
        """One pressure sweep: flight event, then callbacks, then LRU
        shrink of tracked caches (largest first) until under budget.
        Re-entrancy-guarded — callbacks charge/release themselves."""

        if getattr(self._in_pressure, "active", False):
            return
        self._in_pressure.active = True
        try:
            with self._lock:
                self._pressure_events += 1
                total, budget = self._total, self._budget
                cbs = list(self._pressure_cbs)
                caches = [r() for r in self._caches.values()]
            caches = [c for c in caches if c is not None]
            # largest account first; ledger_bytes takes each cache's own
            # lock, so the sort must happen outside the ledger lock
            caches.sort(key=lambda c: -c.ledger_bytes)
            try:
                from distributedkernelshap_tpu_torch.observability.flightrec \
                    import flightrec
                flightrec().record("memory_pressure", total_bytes=total,
                                   budget_bytes=budget,
                                   overage_bytes=overage)
            except Exception:  # pragma: no cover - recorder must not
                pass           # break the charge path
            freed = 0
            for entry in cbs:
                fn = entry() if isinstance(entry, weakref.WeakMethod) \
                    else entry
                if fn is None:
                    continue
                over = self.overage_bytes()
                if over <= 0:
                    break
                try:
                    freed += max(0, int(fn(over) or 0))
                except Exception:
                    logger.exception("memory pressure callback failed")
            for cache in caches:
                over = self.overage_bytes()
                if over <= 0:
                    break
                freed += cache.evict_bytes(over)
            with self._lock:
                self._evicted_bytes += freed
                self._pressure_cbs = [
                    e for e in self._pressure_cbs
                    if not (isinstance(e, weakref.WeakMethod)
                            and e() is None)]
            if self.overage_bytes() > 0:
                logger.warning(
                    "memory pressure: still %d bytes over the %d-byte "
                    "budget after freeing %d (remaining owners hold "
                    "only their MRU entries)", self.overage_bytes(),
                    self._budget, freed)
        finally:
            self._in_pressure.active = False

    # -- views ----------------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def high_water_bytes(self) -> int:
        with self._lock:
            return self._high_water

    def totals(self) -> Dict[Tuple[str, str], int]:
        """``{(owner, model_label): bytes}`` over non-empty accounts."""

        with self._lock:
            out: Dict[Tuple[str, str], int] = {}
            for acct in self._accounts.values():
                if not acct._total:
                    continue
                label = acct.model or DEFAULT_MODEL_LABEL
                k = (acct.owner, label)
                out[k] = out.get(k, 0) + acct._total
            return out

    def owner_totals(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for acct in self._accounts.values():
                if acct._total:
                    out[acct.owner] = out.get(acct.owner, 0) + acct._total
            return out

    def model_totals(self) -> Dict[str, int]:
        """Per-tenant live bytes (the /fleetz rollup's per-replica
        source, via the ``dks_device_bytes`` samples)."""

        with self._lock:
            out: Dict[str, int] = {}
            for acct in self._accounts.values():
                if acct._total:
                    label = acct.model or DEFAULT_MODEL_LABEL
                    out[label] = out.get(label, 0) + acct._total
            return out

    def retire(self, model_id: str, version: Optional[int] = None) -> int:
        """Drop every charge labeled with ``model_id`` (optionally one
        version) — called by the registry on unregister/hot-swap,
        mirroring the costmeter's label retirement.  The callback gauge
        stops rendering the tenant at the next scrape.  Returns the
        bytes dropped."""

        dropped = 0
        with self._lock:
            for acct in self._accounts.values():
                if acct.model != model_id:
                    continue
                if version is not None and acct.version != version:
                    continue
                dropped += acct._total
                acct._charges.clear()
                self._total -= acct._total
                acct._total = 0
        return dropped

    def pressure_events(self) -> int:
        with self._lock:
            return self._pressure_events

    def evicted_bytes(self) -> int:
        with self._lock:
            return self._evicted_bytes

    def note_device(self, device) -> None:
        """Record the device an engine charges from (the engine calls this
        when it opens its tracked caches).  A CUDA device makes
        :meth:`reconcile` read that device's allocator; the CPU leaves it
        unsupported."""

        if getattr(device, "type", None) == "cuda":
            self._device = device

    def reconcile(self) -> Dict:
        """Computed total vs the CUDA caching allocator's
        ``allocated_bytes.all.current`` on the noted device (reported as
        ``bytes_in_use``).  Without a CUDA device there are no allocator
        stats — ``supported: false``, computed-bytes-only."""

        stats = None
        if self._device is not None:
            try:
                import torch

                raw = torch.cuda.memory_stats(self._device)
                if "allocated_bytes.all.current" in raw:
                    stats = {"bytes_in_use":
                             int(raw["allocated_bytes.all.current"])}
            except Exception:
                stats = None
        ledger = self.total_bytes()
        if not stats or "bytes_in_use" not in stats:
            self._last_gap = None
            return {"supported": False, "ledger_bytes": ledger}
        gap = int(stats["bytes_in_use"]) - ledger
        self._last_gap = gap
        return {"supported": True, "ledger_bytes": ledger,
                "bytes_in_use": int(stats["bytes_in_use"]),
                "gap_bytes": gap}

    def snapshot(self) -> Dict:
        """The ``/statusz`` ``detail.memory`` panel."""

        with self._lock:
            owners = {}
            models = {}
            for acct in self._accounts.values():
                if not acct._total:
                    continue
                owners[acct.owner] = owners.get(acct.owner, 0) \
                    + acct._total
                label = acct.model or DEFAULT_MODEL_LABEL
                models[label] = models.get(label, 0) + acct._total
            doc = {
                "enabled": self.enabled,
                "total_bytes": self._total,
                "high_water_bytes": self._high_water,
                "budget_bytes": self._budget,
                "pressure_events": self._pressure_events,
                "evicted_bytes": self._evicted_bytes,
                "owners": owners,
                "models": models,
            }
        doc["reconcile"] = self.reconcile()
        return doc

    def reset(self) -> None:
        """Zero every account and counter (bench/test hook: lets one
        process measure a fresh ledger epoch; live TrackedCaches keep
        working — their stale charge entries release as 0)."""

        with self._lock:
            for acct in self._accounts.values():
                acct._charges.clear()
                acct._total = 0
            self._total = 0
            self._high_water = 0
            self._pressure_events = 0
            self._evicted_bytes = 0
            self._last_gap = None

    # -- metrics --------------------------------------------------------

    def attach_metrics(self, registry) -> None:
        """Register the ledger's families on ``registry`` (callback-
        sourced; several registries may read one process ledger).  The
        model-labeled gauge declares a retire hook — :meth:`retire` runs
        on tenant removal/hot-swap, so churn cannot grow the label
        space."""

        g = registry.gauge(
            "dks_device_bytes",
            "Live device bytes by owning buffer and tenant — computed "
            "nbytes charged to the process memory ledger on every cache "
            "insert/evict (engine device caches, plan constants, result "
            "cache, staging slots, anytime constants).  Retired with "
            "the tenant on unregister/hot-swap.",
            labelnames=("owner", "model"))
        g.set_function(lambda: {k: float(v)
                                for k, v in self.totals().items()})
        registry.declare_retirement("dks_device_bytes")
        registry.gauge(
            "dks_mem_high_water_bytes",
            "High-water mark of the memory ledger's total computed "
            "device bytes since process start (or the last ledger "
            "reset).").set_function(
                lambda: float(self.high_water_bytes()))
        registry.gauge(
            "dks_mem_budget_bytes",
            "Configured soft device-byte budget (DKS_MEM_BUDGET_BYTES; "
            "0 = unlimited).  Charges above it trigger the pressure "
            "sweep.").set_function(lambda: float(self._budget))
        registry.counter(
            "dks_mem_pressure_events_total",
            "Memory-pressure sweeps triggered (total charged bytes "
            "exceeded the soft budget; each sweep also lands a "
            "memory_pressure flight event).").set_function(
                lambda: float(self.pressure_events()))
        registry.counter(
            "dks_mem_evicted_bytes_total",
            "Bytes freed by pressure sweeps (result-cache eviction + "
            "LRU shrink of tracked device caches).  Eviction only "
            "forces recompute — answers stay bit-identical.").\
            set_function(lambda: float(self.evicted_bytes()))
        registry.gauge(
            "dks_mem_reconcile_gap_bytes",
            "Last reconciliation gap: backend allocator bytes_in_use "
            "minus the ledger's computed total.  0 when the backend "
            "exposes no memory_stats (CPU) — the /statusz memory panel "
            "carries the supported flag.").set_function(
                lambda: float(self._last_gap or 0))


_default: Optional[MemLedger] = None
_default_lock = make_lock("memledger.singleton")


def memledger() -> MemLedger:
    """The process-wide ledger (created on first use, honoring the
    ``DKS_MEM_LEDGER`` / ``DKS_MEM_BUDGET_BYTES`` environment)."""

    global _default
    with _default_lock:
        if _default is None:
            _default = MemLedger()
        return _default
