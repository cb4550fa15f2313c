"""Client-side request fan-out.

The reference fans out one HTTP request per instance as Ray remote tasks
(``benchmarks/serve_explanations.py:96-139``: ``distribute_request.remote``
doing ``requests.get(url, json={'array': ...})``).  Here the fan-out is a
thread pool — requests are IO-bound HTTP calls, the server coalesces them
into device batches.

Each worker thread keeps one persistent HTTP/1.1 connection (the server
speaks keep-alive): without reuse, every request costs a TCP handshake and
spawns a fresh handler thread server-side, and on a single-core host that
thread churn starves the GIL the explain pipeline needs.
"""

import http.client
import json
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence
from urllib.parse import urlparse

import numpy as np

import distributedkernelshap_tpu_torch.observability.tracing as _tracing
import distributedkernelshap_tpu_torch.serving.wire as _wire

_tls = threading.local()

# per-host negotiated transport ("binary" | "json"), learned from the
# server's responses: a 415 (or a 400 answered to a binary body — the
# pre-wire servers' reaction, they JSON-parse everything) downgrades the
# host to JSON for the process lifetime, so one failed probe per host is
# the whole negotiation cost.  Shared across threads (benign to race: the
# value converges and every transition is also handled per-request).
_negotiated: dict = {}
_negotiated_lock = threading.Lock()


def reset_negotiation_cache() -> None:
    """Forget learned per-host transports (tests; or after a fleet
    upgrade, to let clients re-probe binary)."""

    with _negotiated_lock:
        _negotiated.clear()

#: ceiling on any single backoff sleep, whatever the server's hint says —
#: a buggy/adversarial ``Retry-After: 86400`` must not park a client thread
#: for a day
MAX_BACKOFF_S = 30.0

#: base for the exponential backoff used when the server gave no hint
#: (connection failures, 502/503 without Retry-After)
BASE_BACKOFF_S = 0.25


def _get_connection(scheme: str, netloc: str,
                    timeout: float) -> http.client.HTTPConnection:
    conns = getattr(_tls, "conns", None)
    if conns is None:
        conns = _tls.conns = {}
    key = (scheme, netloc)
    conn = conns.get(key)
    if conn is None:
        cls = (http.client.HTTPSConnection if scheme == "https"
               else http.client.HTTPConnection)
        conn = conns[key] = cls(netloc, timeout=timeout)
    elif conn.timeout != timeout:
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
    return conn


def _drop_connection(scheme: str, netloc: str) -> None:
    conn = getattr(_tls, "conns", {}).pop((scheme, netloc), None)
    if conn is not None:
        conn.close()


def parse_retry_after(headers, payload) -> Optional[float]:
    """A 429's backoff hint: ``Retry-After`` header, else ``retry_after_s``
    in the JSON body; ``None`` when absent or garbled.  The ONE parser of
    this wire hint — the fan-in proxy layers its own floor/default on
    top (``FanInProxy._retry_after_s``)."""

    value = headers.get("Retry-After") if headers else None
    if value is not None:
        try:
            return max(0.0, float(value))
        except ValueError:
            pass
    try:
        return max(0.0, float(json.loads(payload)["retry_after_s"]))
    except (ValueError, KeyError, TypeError):
        return None


def _request_body(instance: np.ndarray, binary: bool,
                  extra_headers: Optional[dict], stream: bool = False):
    """(body, headers) for one transport: binary wire framing (raw float32
    row bytes + binary Accept) or the historical JSON document.

    ``stream`` prepends the round-stream content type to the Accept list.
    A pre-anytime server ignores the unknown entry and matches whatever
    else the list offers (plain wire, or nothing -> JSON) — streaming
    negotiation rides the SAME request, no extra probe."""

    if binary:
        body = _wire.encode_request(instance)
        headers = {"Content-Type": _wire.CONTENT_TYPE,
                   "Accept": _wire.CONTENT_TYPE}
    else:
        body = json.dumps({"array": np.asarray(instance).tolist()}).encode()
        headers = {"Content-Type": "application/json"}
    if stream:
        headers["Accept"] = (_wire.STREAM_CONTENT_TYPE
                             + (", " + headers["Accept"]
                                if "Accept" in headers else ""))
    headers.update(extra_headers or {})
    return body, headers


def _read_exact(resp, n: int) -> bytes:
    """Read exactly ``n`` bytes from a response (http.client de-chunks);
    a short read means the server tore the stream mid-frame."""

    chunks = []
    got = 0
    while got < n:
        piece = resp.read(n - got)
        if not piece:
            raise _wire.WireError(
                f"stream torn mid-frame: wanted {n} bytes, got {got}")
        chunks.append(piece)
        got += len(piece)
    return b"".join(chunks)


def _read_stream(resp, on_partial: Optional[Callable]) -> dict:
    """Consume a round-frame stream incrementally: each frame is decoded
    the moment its bytes arrive (header first, then exactly the declared
    payload — partial results reach ``on_partial`` without buffering the
    whole response), and the final frame's structured dict is returned.
    Raises :class:`wire.WireError`/:class:`wire.WireVersionError` on torn
    frames or unknown stream versions — a half-written frame can never
    surface as phi."""

    while True:
        header = _read_exact(resp, _wire.STREAM_HEADER_SIZE)
        length = _wire.stream_frame_length(header)
        payload = _read_exact(resp, length) if length else b""
        frame, _ = _wire.decode_round_frame(header + payload)
        if frame["final"]:
            if resp.read():  # drain the chunked terminator for keep-alive
                raise _wire.WireError("stream carries bytes past the "
                                      "final frame")
            return frame
        if on_partial is not None:
            on_partial(frame)


def explain_request(url: str, instance: np.ndarray, timeout: float = 300.0,
                    max_retries: int = 4,
                    extra_headers: Optional[dict] = None,
                    wire_format: str = "json",
                    stream: bool = False,
                    on_partial: Optional[Callable[[dict], None]] = None,
                    _sleep: Callable[[float], None] = time.sleep,
                    _rng: Optional[random.Random] = None):
    """POST one instance (or minibatch) to the explanation endpoint and
    return the payload, reusing this thread's connection.

    ``wire_format`` selects the transport and the return type:

    * ``'json'`` (default, the historical contract) — JSON request body,
      returns the raw Explanation JSON payload ``str``.
    * ``'binary'`` / ``'auto'`` — the zero-copy wire protocol
      (``serving/wire.py``): binary request body + binary ``Accept``;
      returns a dict ``{'shap_values': [K x (B, M)], 'expected_value',
      'raw_prediction'}`` whatever transport the negotiation lands on.
      A server answering 415 (a future-version decoder) **or** 400 to the
      binary body (a pre-wire server JSON-parsing everything) downgrades
      this host to JSON for the process (``reset_negotiation_cache`` to
      re-probe); the downgraded request is re-sent as JSON on the same
      connection without consuming the retry budget, and the structured
      dict is then extracted from the JSON document — callers never see
      the transport.

    ``stream=True`` asks for progressive refinement (anytime serving):
    the round-stream content type is prepended to the Accept list, and
    against a stream-capable server each partial round frame is decoded
    the moment it arrives and handed to ``on_partial`` (a dict with
    ``shap_values``/``expected_value``/``raw_prediction``/``round``/
    ``converged``/``est_err``), in round order; the call returns the
    FINAL frame's dict.  Against a pre-anytime server or proxy the
    unknown Accept entry is ignored and the response degrades to one
    ordinary answer (plain wire or JSON, whatever the rest of the list
    negotiates): ``on_partial`` is never called and the single answer is
    returned as the same structured dict — so ``stream=True`` always
    returns a dict, whatever ``wire_format`` says, and works unchanged
    against every server generation.  A stream torn mid-frame (or
    carrying an unknown stream version) never surfaces partial phi: the
    connection is dropped and the request retried within the ordinary
    budget (``on_partial`` may then see early rounds again — partials
    are idempotent refinements, replaying them is harmless).

    Retriable failures are retried within a bounded budget
    (``max_retries`` beyond the first attempt), with capped, jittered
    backoff:

    * **429** — the server's explicit backpressure.  The ``Retry-After``
      hint is HONOURED (capped at :data:`MAX_BACKOFF_S`, with up to 25%
      added jitter so a shed burst doesn't resynchronise into a retry
      stampede at exactly hint seconds).
    * **502 / 503** — a crashed-mid-request or self-declared-unserviceable
      replica behind a fan-in.  Explanations are deterministic and
      content-addressed, so re-sending is idempotent: a duplicate
      execution produces a bit-identical payload (and on a cache-enabled
      server costs no second device call).  Exponential backoff from
      :data:`BASE_BACKOFF_S`.
    * **connection failures** — retried through a fresh connection (the
      request may never have been sent).
    * **undecodable payloads** — a response body that is not valid UTF-8
      was corrupted on the wire; a re-fetch is idempotent and returns the
      clean (bit-identical) answer.

    NOT retried: timeouts (the request may still be queued server-side —
    re-sending duplicates load on an already-struggling server; the 504
    status a proxy synthesises for a slow replica is equally terminal
    here), and any other HTTP error (4xx/500 are answers, not outages).
    ``_sleep``/``_rng`` are test seams.

    Tracing (``DKS_TRACE=1``): the client MINTS the trace id — one
    ``client.request`` root span per call, one ``client.attempt`` child
    span per wire attempt (retries get distinct span ids), and the
    attempt's context rides the ``X-DKS-Trace`` header so proxy and
    replica spans downstream share the trace id.
    """

    parsed = urlparse(url)
    path = parsed.path or "/"
    if wire_format not in ("json", "binary", "auto"):
        raise ValueError(f"wire_format must be 'json', 'binary' or 'auto', "
                         f"got {wire_format!r}")
    host_key = (parsed.scheme or "http", parsed.netloc)
    with _negotiated_lock:
        negotiated = _negotiated.get(host_key)
    # binary unless this host already downgraded; plain 'json' never probes
    sent_binary = wire_format != "json" and negotiated != "json"
    body, headers = _request_body(instance, sent_binary, extra_headers,
                                  stream=stream)
    rng = _rng or random.Random()
    tr = _tracing.tracer()
    root = None
    if tr.enabled:
        # an explicit X-DKS-Trace in extra_headers adopts the caller's
        # trace (batch drivers stamping one trace across a fan-out)
        root = tr.begin("client.request",
                        parent=_tracing.parse_trace_header(
                            _tracing.header_get(headers)),
                        rows=int(np.asarray(instance).reshape(
                            -1, np.asarray(instance).shape[-1]).shape[0]))
    attempt = 0
    last_status = None
    tentative_400 = False
    try:
        while True:
            conn = _get_connection(parsed.scheme or "http", parsed.netloc,
                                   timeout)
            backoff = None
            aspan = None
            if root is not None:
                aspan = tr.begin("client.attempt", parent=root.context,
                                 attempt=attempt)
                headers = {k: v for k, v in headers.items()
                           if k.lower() != _tracing.TRACE_HEADER.lower()}
                headers[_tracing.TRACE_HEADER] = \
                    _tracing.format_trace_header(aspan.context)
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                ctype = (resp.headers.get("Content-Type")
                         or "").split(";", 1)[0].strip().lower()
                if stream and resp.status == 200 \
                        and ctype == _wire.STREAM_CONTENT_TYPE:
                    last_status = resp.status
                    try:
                        frame = _read_stream(resp, on_partial)
                        tr.end(aspan, status=resp.status,
                               rounds=frame["round"] + 1)
                        return frame
                    except (_wire.WireError, ValueError) as e:
                        # a torn/garbled stream never surfaces partial
                        # phi: drop the (desynced) connection and
                        # re-fetch — rounds are deterministic, so a
                        # replayed stream is bit-identical
                        tr.end(aspan, outcome="stream_torn")
                        _drop_connection(parsed.scheme or "http",
                                         parsed.netloc)
                        if attempt >= max_retries:
                            raise RuntimeError(
                                f"HTTP 200: torn round-frame stream "
                                f"({e})") from e
                        backoff = BASE_BACKOFF_S * (2.0 ** attempt)
                        attempt += 1
                        _sleep(min(MAX_BACKOFF_S,
                                   backoff * (1.0 + 0.25 * rng.random())))
                        continue
                raw = resp.read()
                last_status = resp.status
                tr.end(aspan, status=resp.status)
                if sent_binary and resp.status in (415, 400):
                    # the server does not speak the wire format — 415 is
                    # the explicit signal (version mismatch), 400 the
                    # pre-wire servers' reaction (they JSON-parse every
                    # body).  Downgrade the host and re-send as JSON on
                    # the SAME connection; negotiation is not a failure,
                    # so the retry budget is untouched.  sent_binary is
                    # now False, so a second 415/400 is terminal.  A 400
                    # is only a TENTATIVE verdict: a wire-capable server
                    # also answers 400 for a bad SLO header, and caching
                    # 'json' off that would silently disable the binary
                    # transport for every later request to the host — so
                    # the cached verdict is withdrawn below if the JSON
                    # re-send draws the same 400 (the request itself was
                    # bad, not the transport).
                    tentative_400 = resp.status == 400
                    with _negotiated_lock:
                        _negotiated[host_key] = "json"
                    sent_binary = False
                    body, headers = _request_body(instance, False,
                                                  extra_headers,
                                                  stream=stream)
                    continue
                if tentative_400 and resp.status == 400:
                    # the JSON re-send failed identically: the 400 was
                    # about THIS request, not the wire format — forget
                    # the downgrade so the host keeps its binary path
                    with _negotiated_lock:
                        if _negotiated.get(host_key) == "json":
                            del _negotiated[host_key]
                resp_binary = _wire.is_wire_content_type(
                    resp.headers.get("Content-Type"))
                if resp_binary:
                    payload = raw  # framing validated at decode below
                else:
                    try:
                        payload = raw.decode()
                    except UnicodeDecodeError:
                        # corrupted on the wire (bit-rot, an injected
                        # garble): idempotency makes a re-fetch safe, so
                        # spend a retry on a clean copy instead of
                        # surfacing garbage — but only for statuses that
                        # are retriable anyway; a garbled 400/500 is still
                        # an answer the server would deterministically
                        # repeat
                        if resp.status not in (200, 429, 502, 503) \
                                or attempt >= max_retries:
                            raise RuntimeError(
                                f"HTTP {resp.status}: undecodable (corrupt) "
                                f"payload of {len(raw)} bytes")
                        payload = None
                        backoff = BASE_BACKOFF_S * (2.0 ** attempt)
                if payload is not None:
                    if resp.status == 200:
                        if wire_format == "json" and not stream:
                            return payload
                        try:
                            return (_wire.decode_explanation(payload)
                                    if resp_binary else
                                    _wire.explanation_payload_from_json(
                                        payload))
                        except (_wire.WireError, ValueError, KeyError):
                            # structured-mode analog of the undecodable
                            # branch: a torn/garbled 200 body re-fetches
                            # bit-identically
                            if attempt >= max_retries:
                                raise RuntimeError(
                                    f"HTTP 200: unparseable explanation "
                                    f"payload of {len(raw)} bytes")
                            backoff = BASE_BACKOFF_S * (2.0 ** attempt)
                    elif resp.status == 429:
                        hint = parse_retry_after(resp.headers, payload)
                        backoff = hint if hint is not None else \
                            BASE_BACKOFF_S * (2.0 ** attempt)
                    elif resp.status in (502, 503):
                        backoff = BASE_BACKOFF_S * (2.0 ** attempt)
                    if backoff is None or attempt >= max_retries:
                        raise RuntimeError(f"HTTP {resp.status}: {payload}")
            except TimeoutError:
                # a timed-out request may still be queued server-side;
                # re-sending it would duplicate work on an
                # already-overloaded server
                tr.end(aspan, outcome="timeout")
                _drop_connection(parsed.scheme or "http", parsed.netloc)
                raise
            except (http.client.HTTPException, ConnectionError, OSError):
                tr.end(aspan, outcome="connection_failed")
                _drop_connection(parsed.scheme or "http", parsed.netloc)
                if attempt >= max_retries:
                    raise
                backoff = BASE_BACKOFF_S * (2.0 ** attempt)
            attempt += 1
            # jitter INSIDE the cap: MAX_BACKOFF_S is a hard ceiling
            _sleep(min(MAX_BACKOFF_S,
                       backoff * (1.0 + 0.25 * rng.random())))
    finally:
        if root is not None:
            tr.end(root, attempts=attempt + 1, status=last_status)


def distribute_requests(url: str,
                        data: np.ndarray,
                        batch_mode: str = "ray",
                        minibatches: Optional[Sequence[np.ndarray]] = None,
                        max_workers: int = 16,
                        timeout: float = 300.0,
                        wire_format: str = "json") -> List:
    """Fan requests out to the endpoint.

    ``batch_mode='ray'`` mirrors the reference's server-side batching mode
    (one single-row request per instance, ``k8s_serve_explanations.py:181``);
    ``'default'`` sends client-side minibatches (``:184``), either supplied
    via ``minibatches`` or one row each.

    ``max_workers`` bounds the in-flight requests; the default is sized for a
    colocated single-core client, where more threads only fight the serving
    pipeline for the GIL.

    ``wire_format`` is forwarded to :func:`explain_request` — ``'json'``
    (default) returns payload strings, ``'binary'``/``'auto'`` structured
    dicts over the negotiated zero-copy transport.
    """

    if batch_mode == "ray" or minibatches is None:
        parts = np.split(data, data.shape[0])
    else:
        parts = list(minibatches)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(explain_request, url, p, timeout,
                               wire_format=wire_format) for p in parts]
        return [f.result() for f in futures]
