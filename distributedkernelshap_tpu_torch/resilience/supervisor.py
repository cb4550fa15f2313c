"""Replica process supervision: restart-on-crash with crash-loop backoff.

The reference's replicas were Ray Serve actors with ``restartPolicy:
Always`` behind them; a crashed backend respawned and rejoined routing
automatically.  The jax_graft port's ``ReplicaManager`` grew a minimal
restart loop (fixed 1 s backoff, no proxy integration); this module is
its grown-up replacement:

* **crash-loop protection** — a replica that dies immediately after
  every start (poisoned model file, bad device) is restarted with
  exponential backoff + jitter instead of hot-looping spawn/crash cycles
  that burn a CPU and spam logs; an incarnation that stays up
  ``healthy_reset_s`` resets the backoff.
* **membership agreement** — the supervisor marks a dead replica out of
  the fan-in proxy's rotation the moment the process exits, instead of
  letting clients discover the corpse via failed connects; recovery
  stays owned by the proxy's ``/healthz`` prober, so exactly one
  component (the prober) ever declares a replica live, and exactly one
  (the supervisor or a failed connect) declares it dead.
* **elastic membership** — the autoscaler (``serving/autoscaler.py``)
  grows the fleet mid-run (:meth:`ReplicaSupervisor.track` puts a
  freshly spawned worker under supervision) and shrinks it by DRAINING:
  a retired replica (:meth:`ReplicaSupervisor.retire`) exited on
  purpose, so its process exit must NOT trigger a restart — retirement
  is the one exit the crash loop is wrong about.

Used by ``serving/replicas.ReplicaManager``; standalone-usable for any
list of worker ``Popen`` objects plus a spawn function.
"""

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from distributedkernelshap_tpu_torch.analysis import lockwitness
from distributedkernelshap_tpu_torch.observability.flightrec import flightrec

logger = logging.getLogger(__name__)


class RestartPolicy:
    """Exponential backoff with jitter for crash-looping replicas.

    ``delay(n)`` for the n-th CONSECUTIVE crash (n >= 1) is
    ``base_backoff_s * 2**(n-1)`` capped at ``max_backoff_s``, plus
    uniform jitter of ``jitter_frac`` of the delay (jitter decorrelates a
    fleet that all crashed on the same poisoned input, so the restarts
    don't stampede the shared model store / device pool).  Seedable for
    deterministic tests.
    """

    def __init__(self, base_backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0,
                 jitter_frac: float = 0.25,
                 healthy_reset_s: float = 60.0,
                 seed: Optional[int] = None):
        if base_backoff_s <= 0 or max_backoff_s < base_backoff_s:
            raise ValueError("need 0 < base_backoff_s <= max_backoff_s")
        if not 0.0 <= jitter_frac <= 1.0:
            raise ValueError("jitter_frac must be in [0, 1]")
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter_frac = float(jitter_frac)
        self.healthy_reset_s = float(healthy_reset_s)
        self._rng = random.Random(seed)

    def delay(self, consecutive_crashes: int) -> float:
        n = max(1, int(consecutive_crashes))
        base = min(self.max_backoff_s,
                   self.base_backoff_s * (2.0 ** (n - 1)))
        return base * (1.0 + self.jitter_frac * self._rng.random())


class ReplicaSupervisor:
    """Monitors worker processes and restarts exited ones.

    Parameters
    ----------
    procs
        The SHARED list of worker ``Popen`` objects — restarts replace
        entries in place, so the owner (``ReplicaManager``) always sees
        the live incarnation.
    spawn
        ``spawn(index) -> Popen`` relaunching one worker.
    proxy
        Optional ``FanInProxy``: on process exit the replica is marked
        out of rotation immediately (``alive = False``); the proxy's own
        prober re-admits it once ``/healthz`` answers.
    policy
        :class:`RestartPolicy`; defaults are production-shaped.
    lock
        Optional externally owned lock serialising respawn against the
        owner's shutdown sweep (``ReplicaManager`` passes its procs
        lock); an internal lock is created otherwise.
    """

    def __init__(self, procs: List, spawn: Callable[[int], object],
                 proxy=None, policy: Optional[RestartPolicy] = None,
                 poll_interval_s: float = 0.5,
                 lock: Optional[threading.Lock] = None):
        self.procs = procs
        self.spawn = spawn
        self.proxy = proxy
        self.policy = policy or RestartPolicy()
        self.poll_interval_s = float(poll_interval_s)
        self.lock = lock or threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-replica crash bookkeeping, guarded by its OWN lock
        # (DKS-C001: track/retire/stats arrive from the autoscaler and
        # statusz threads while _tick mutates).  Deliberately distinct
        # from self.lock — the owner may pass its procs lock there and
        # call is_retired() while holding it (ReplicaManager.
        # spawn_replica does), so reusing it here would self-deadlock.
        # Order is always self.lock -> _book_lock, never the reverse.
        self._book_lock = lockwitness.make_lock("supervisor.book")
        self._consecutive: Dict[int, int] = {}
        self._last_start: Dict[int, float] = {}
        self._respawn_at: Dict[int, float] = {}
        # indices retired ON PURPOSE (autoscaler drain): their exit is the
        # goal, not a crash — never respawned
        self._retired: set = set()
        self.restarts_total = 0
        self.crash_loops_backing_off = 0

    # ------------------------------------------------------------------ #

    def _mark_down(self, index: int) -> None:
        if self.proxy is None:
            return
        try:
            replica = self.proxy.replicas[index]
        except IndexError:
            return
        if replica.alive:
            replica.alive = False
            logger.warning("supervisor: replica %d exited; removed from "
                           "rotation pending restart", index)

    def _tick(self) -> None:
        # crash bookkeeping (consecutive counts, respawn stamps, the
        # retired set) is shared with the autoscaler thread (track /
        # retire) and statusz readers (stats) — every touch goes through
        # _book_lock (DKS-C001); the proxy/log/flightrec side effects and
        # the spawn itself run after release so the lock never brackets
        # I/O or process creation (DKS-C004)
        now = time.monotonic()
        for i, proc in enumerate(list(self.procs)):
            if proc is None or proc.poll() is None:
                continue
            backoff_event = None
            respawn_due = False
            with self._book_lock:
                if i in self._retired:
                    continue  # drained on purpose: its exit is the goal
                due = self._respawn_at.get(i)
                if due is None:
                    lived = now - self._last_start.get(i, 0.0)
                    if lived >= self.policy.healthy_reset_s:
                        self._consecutive[i] = 1
                    else:
                        self._consecutive[i] = \
                            self._consecutive.get(i, 0) + 1
                    delay = self.policy.delay(self._consecutive[i])
                    self._respawn_at[i] = now + delay
                    if self._consecutive[i] > 1:
                        self.crash_loops_backing_off += 1
                    backoff_event = (proc.returncode,
                                     self._consecutive[i], delay)
                elif now >= due:
                    respawn_due = True
            # dead: the proxy must stop routing to the corpse NOW — the
            # prober only recovers, the supervisor (and failed connects)
            # declare death.  Idempotent, so re-marking each tick while
            # the backoff runs down is fine.
            self._mark_down(i)
            if backoff_event is not None:
                returncode, consecutive, delay = backoff_event
                logger.warning(
                    "supervisor: replica %d exited rc=%s (consecutive "
                    "crash #%d); restarting in %.2fs",
                    i, returncode, consecutive, delay)
                flightrec().record("replica_exit", replica=i,
                                   returncode=returncode,
                                   consecutive_crashes=consecutive,
                                   restart_in_s=round(delay, 3))
                continue
            if not respawn_due:
                continue
            with self.lock:
                if self._stop.is_set():
                    return  # shutdown won the race: never respawn
                with self._book_lock:
                    if i in self._retired:
                        continue  # retire won the race mid-backoff
                # the spawn (process creation, hundreds of ms) runs under
                # self.lock ONLY — stats()/is_retired() must not stall
                # behind it.  A retire landing in this window is the same
                # pre-existing race as retire-after-respawn: the next
                # tick sees the slot retired and never respawns again.
                self.procs[i] = self.spawn(i)
                with self._book_lock:
                    self._last_start[i] = time.monotonic()
                    self._respawn_at.pop(i, None)
                    self.restarts_total += 1
                    restarts = self.restarts_total
            logger.info("supervisor: replica %d respawned "
                        "(restart #%d)", i, restarts)
            flightrec().record("replica_restart", replica=i,
                               restarts_total=restarts)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self._tick()
            except Exception:
                # the supervisor dying silently would turn every later
                # crash into a permanent outage — log and keep running
                logger.exception("supervisor tick failed")

    # ------------------------------------------------------------------ #

    def start(self) -> "ReplicaSupervisor":
        now = time.monotonic()
        with self._book_lock:
            for i in range(len(self.procs)):
                self._last_start[i] = now
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop restarting.  The owner then sweeps/terminates the procs
        under :attr:`lock`, which this stop flag guarantees no respawn
        can interleave with."""

        self._stop.set()

    # -- elastic membership (autoscaler) -------------------------------- #

    def track(self, index: int) -> None:
        """Put a freshly spawned worker at ``procs[index]`` under
        supervision: stamp its start time (a scaler-spawned worker must
        earn ``healthy_reset_s`` like any other incarnation) and clear
        any retirement left over from a previously drained slot being
        reused."""

        with self._book_lock:
            self._last_start[index] = time.monotonic()
            self._consecutive.pop(index, None)
            self._respawn_at.pop(index, None)
            self._retired.discard(index)

    def retire(self, index: int) -> None:
        """Mark one replica as retired ON PURPOSE (the autoscaler's
        drain-based scale-down): its upcoming process exit is the desired
        outcome, so the crash-restart loop must skip it.  Distinct from
        :meth:`stop`, which ends supervision fleet-wide."""

        with self._book_lock:
            self._retired.add(index)
            self._respawn_at.pop(index, None)

    def is_retired(self, index: int) -> bool:
        with self._book_lock:
            return index in self._retired

    def stats(self) -> Dict[str, int]:
        with self._book_lock:
            return {
                "restarts_total": self.restarts_total,
                "crash_loops_backing_off": self.crash_loops_backing_off,
                "retired": len(self._retired)}
