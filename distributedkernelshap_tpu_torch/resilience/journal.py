"""Shard-granular checkpoint/resume for long batch explain runs (port of
``distributedkernelshap_tpu/resilience/journal.py``).

A 2560-instance batch run is a sequence of independent device calls
(the chunks of a :func:`~distributedkernelshap_tpu_torch.parallel.pipeline.
run_pipeline` loop).  The reference could lean on
Ray's object-store lineage to survive a dead worker; here a killed run
would recompute everything from scratch.  This journal makes the slab
loop restartable: every completed shard's fetched result is appended to
an on-disk journal, and a resumed run replays journaled shards from disk
— bit-identical, since the stored bytes are the exact fetched arrays —
recomputing only shards that had not durably completed.

Format: JSON lines.  Line 1 is a header carrying the format magic and
the *run key* ingredients (model fingerprint, input digest, shard
layout); subsequent lines are ``{"index", "digest", "payload"}`` records
with the shard's result tuple as a base64 ``.npz`` (``allow_pickle``
off).  Appends are flushed and fsynced before the shard is considered
complete, so a crash loses at most the shard in flight.

Invalidation contract: the journal is keyed by the scheduling layer's
model fingerprint (plus the input digest and shard layout).  ANY
mismatch — refit on new background, different grouping, different
nsamples, different input batch — means the header does not match and
the journal is ignored and restarted, never partially reused.  A record
that fails its digest or decode (torn final write) is dropped; a torn
record therefore degrades to "recompute that shard", not corruption.
"""

import base64
import hashlib
import io
import json
import logging
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from distributedkernelshap_tpu_torch.observability.flightrec import flightrec
from distributedkernelshap_tpu_torch.scheduling.result_cache import (
    _collect_content,
    array_fingerprint,
)

logger = logging.getLogger(__name__)

FORMAT = "dks-shard-journal-v1"


def _host(value) -> np.ndarray:
    """``value`` as a host numpy array: a torch tensor (on the card too) is
    read back first, where ``np.asarray`` of a CUDA tensor raises."""

    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _normalise(value):
    """Map a value onto restart-stable hashable content: arrays and
    tensors become host numpy (content, not repr — numpy elides large
    middles and tensor reprs carry devices), callables/objects collapse
    to their qualified type name."""

    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, np.ndarray):
        return value
    if hasattr(value, "shape") and hasattr(value, "dtype") \
            and (hasattr(value, "__array__") or hasattr(value, "detach")):
        return _host(value)
    if isinstance(value, (list, tuple)):
        return [_normalise(v) for v in value]
    if isinstance(value, dict):
        return {repr(k): _normalise(v) for k, v in value.items()}
    if callable(value):
        return f"callable:{getattr(value, '__qualname__', type(value).__name__)}"
    return f"obj:{type(value).__qualname__}"


def _predictor_content_digest(predictor) -> str:
    """Restart- and device-stable digest of a predictor's content: its
    published ``fingerprint_bytes()`` where it has them, else every
    parameter tensor and scalar attribute reachable from its attributes,
    each tensor read back to the host (the scheduling layer's content
    walk), so the same model on the CPU and on the card hashes the same
    and nothing depends on ``id()``."""

    h = hashlib.sha256()
    h.update(type(predictor).__qualname__.encode())
    fp_bytes = getattr(predictor, "fingerprint_bytes", None)
    declared = fp_bytes() if callable(fp_bytes) else None
    if declared is not None:
        h.update(b"declared:")
        h.update(declared)
    else:
        _collect_content(getattr(predictor, "__dict__", None) or {}, h)
    return h.hexdigest()


def _update(h, value) -> None:
    value = _normalise(value)
    if isinstance(value, np.ndarray):
        h.update(b"nd:")
        h.update(array_fingerprint(value).encode())
    elif isinstance(value, list):
        h.update(f"seq{len(value)}:".encode())
        for item in value:
            _update(h, item)
    elif isinstance(value, dict):
        h.update(f"map{len(value)}:".encode())
        for key in sorted(value):
            h.update(key.encode())
            _update(h, value[key])
    else:
        h.update(repr(value).encode())


def journal_fingerprint(engine, extra: Optional[dict] = None) -> str:
    """Restart-stable fingerprint of a fitted explainer engine.

    The scheduling layer's :func:`model_fingerprint` is in-process (its
    predictor-identity fallback is ``id(predictor)``, which changes every
    restart — correct for a serving cache, useless for resume).  This
    variant hashes the predictor by CONTENT
    (:func:`_predictor_content_digest`: declared content bytes, else its
    parameter tensors and scalar attributes, read back to the host),
    alongside the same background / weights / link / seed / groups
    ingredients.  An engine (or wrapper) may pin its own ``fingerprint``
    attribute — e.g. a checkpoint-weights hash — which then wins
    outright, mirroring ``model_fingerprint``.
    """

    explicit = getattr(engine, "fingerprint", None)
    if isinstance(explicit, str) and explicit:
        return explicit
    h = hashlib.sha256()
    background = getattr(engine, "background", None)
    if background is not None:
        h.update(array_fingerprint(_host(background)).encode())
    bg_weights = getattr(engine, "bg_weights", None)
    if bg_weights is not None:
        h.update(array_fingerprint(_host(bg_weights)).encode())
    config = getattr(engine, "config", None)
    h.update(repr(getattr(config, "link", None)).encode())
    h.update(repr(getattr(config, "seed",
                          getattr(engine, "seed", None))).encode())
    _update(h, getattr(engine, "groups", None))
    predictor = getattr(engine, "predictor", None)
    h.update(_predictor_content_digest(predictor).encode())
    _update(h, extra or {})
    return h.hexdigest()


def _encode_arrays(arrays: Sequence[np.ndarray]) -> Tuple[str, str]:
    """(base64 npz, sha256 of the raw npz bytes)."""

    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": _host(a) for i, a in enumerate(arrays)})
    raw = buf.getvalue()
    return (base64.b64encode(raw).decode("ascii"),
            hashlib.sha256(raw).hexdigest())


def _decode_arrays(payload: str, digest: str) -> Optional[Tuple[np.ndarray, ...]]:
    try:
        raw = base64.b64decode(payload.encode("ascii"), validate=True)
    except (ValueError, TypeError):
        return None
    if hashlib.sha256(raw).hexdigest() != digest:
        return None
    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            return tuple(z[f"a{i}"] for i in range(len(z.files)))
    except (KeyError, ValueError, OSError):
        return None


class ShardJournal:
    """Append-only journal of completed shard results for ONE run.

    ``meta`` identifies the run (model fingerprint, input digest, shard
    count, explain options); an existing file whose header does not match
    byte-for-byte is discarded and restarted — the invalidation contract.
    ``put`` is durable (flush + fsync) before it returns, so a recorded
    shard survives any crash after it.  Thread-safe: fetch threads from
    the bounded pipeline append concurrently.
    """

    def __init__(self, path: str, meta: Dict[str, Any]):
        self.path = path
        self.meta = {"format": FORMAT, **meta}
        self._lock = threading.Lock()
        # decoded resume data, held only until get() hands it out; _done
        # tracks completion for BOTH restored and freshly put shards so a
        # fresh put never keeps a second in-memory copy of its result
        # (the pipeline's own results list already holds it)
        self._entries: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._done: set = set()
        self.restored = 0       # shards replayed from disk this run
        self.computed = 0       # shards recorded fresh this run
        self._load()
        self._fh = open(self.path, "a", encoding="ascii")

    def _load(self) -> None:
        if not os.path.exists(self.path):
            self._write_header()
            return
        try:
            with open(self.path, "r", encoding="ascii") as fh:
                lines = fh.read().splitlines()
        except OSError:
            logger.warning("unreadable shard journal %s; restarting it",
                           self.path)
            self._write_header()
            return
        header = None
        if lines:
            try:
                header = json.loads(lines[0])
            except ValueError:
                pass
        if header != self.meta:
            if lines:
                logger.warning(
                    "shard journal %s belongs to a different run "
                    "(fingerprint/input/layout changed); ignoring it",
                    self.path)
                # invalidations are exactly what a resume post-mortem
                # needs on the flight-recorder timeline: "why did this
                # run recompute everything?"
                flightrec().record("journal_invalidated", path=self.path,
                                   records=max(0, len(lines) - 1))
            self._write_header()
            return
        for line in lines[1:]:
            try:
                rec = json.loads(line)
                index = int(rec["index"])
                arrays = _decode_arrays(rec["payload"], rec["digest"])
            except (ValueError, KeyError, TypeError):
                arrays = None
            if arrays is None:
                # torn tail write (the crash landed mid-append): that
                # shard simply recomputes
                logger.warning("dropping undecodable record in %s",
                               self.path)
                flightrec().record("journal_torn_record", path=self.path)
                continue
            self._entries[index] = arrays
            self._done.add(index)
        if self._entries:
            logger.info("shard journal %s: resuming with %d completed "
                        "shard(s)", self.path, len(self._entries))
            flightrec().record("journal_resume", path=self.path,
                               restored_shards=len(self._entries))

    def _write_header(self) -> None:
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(self.path, "w", encoding="ascii") as fh:
            fh.write(json.dumps(self.meta, sort_keys=False) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._entries = {}
        self._done = set()

    # ------------------------------------------------------------------ #

    def get(self, index: int) -> Optional[Tuple[np.ndarray, ...]]:
        with self._lock:
            # pop: once handed to the caller (the pipeline's results
            # list) the journal's copy is redundant host memory
            arrays = self._entries.pop(index, None)
            if arrays is not None:
                self.restored += 1
            return arrays

    def put(self, index: int, arrays: Sequence[np.ndarray]) -> None:
        payload, digest = _encode_arrays(arrays)
        line = json.dumps({"index": int(index), "digest": digest,
                           "payload": payload}) + "\n"
        with self._lock:
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._done.add(int(index))
            self.computed += 1

    @property
    def completed(self) -> int:
        with self._lock:
            return len(self._done)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"path": self.path, "completed": len(self._done),
                    "restored": self.restored, "computed": self.computed}

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_journal_path(checkpoint_dir: str, fingerprint: str,
                     input_digest: str) -> str:
    """Content-addressed journal filename: the same (model, input, opts)
    resumes the same file; anything else gets a fresh one."""

    key = hashlib.sha256(f"{fingerprint}:{input_digest}".encode()).hexdigest()
    return os.path.join(checkpoint_dir, f"shards-{key[:24]}.journal")
