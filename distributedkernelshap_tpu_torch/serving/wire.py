"""Binary batch wire format for the streaming hot path.

PR 5 left small-B linear requests at ~2.7 ms of device work, so per-request
cost became the Python/HTTP plumbing around it: ``json.dumps({"array":
x.tolist()})`` on the client, ``json.loads`` + float-list re-materialisation
on the server, and a full ``Explanation.to_json`` per answered request.  This
module is the wire half of killing that overhead (ISSUE 6; ROADMAP open item
3, grounded in the Gemma-on-TPU host-overhead analysis, PAPERS.md arXiv
2605.25645): a versioned little-endian binary framing whose payloads are the
raw row bytes — the server ingests them with ``np.frombuffer`` (zero copy)
and the response rides raw ``phi`` bytes instead of a JSON document.

Framing (all integers little-endian)::

    message  := magic(4s="DKSW") version(u16) n_arrays(u16) array*
    array    := name_len(u16) name(utf-8) dtype(u8) ndim(u8)
                shape(ndim x u32) payload(raw C-order bytes)

``dtype`` is a code from :data:`DTYPE_CODES` (f32/f64/f16/i32/i64/u8/bool);
the payload length is implied by shape x itemsize, so a torn body is
detected by running off the end of the buffer (:class:`WireError`, which the
server maps to 400 — never a crash).  A version the decoder does not speak
raises :class:`WireVersionError` (server: 415), which is the client's
downgrade-to-JSON signal.

Negotiation is standard HTTP content negotiation so pre-existing JSON
clients keep working unchanged:

* request: ``Content-Type: application/x-dks-wire`` marks a binary body
  (anything else is parsed as the historical JSON ``{"array": ...}``);
* response: the client asks with ``Accept: application/x-dks-wire`` and the
  server answers binary only when it can — otherwise the response is the
  historical Explanation JSON and the client falls back on the response's
  own ``Content-Type``.

Parsing cost: decoding a binary batch is one ``np.frombuffer`` view —
measured >=100x cheaper than ``json.loads`` + ``np.asarray`` for float64
rows at realistic widths (see ``tests/test_streaming.py``'s roundtrip and
``benchmarks/streaming_bench.py`` for the end-to-end effect).
"""

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

#: media type negotiated for both directions
CONTENT_TYPE = "application/x-dks-wire"
#: protocol version this build speaks (encoder always emits it)
WIRE_VERSION = 1
#: human-readable protocol name recorded by benchmarks
WIRE_FORMAT_NAME = f"dks-wire-v{WIRE_VERSION}"

_MAGIC = b"DKSW"
_HEADER = struct.Struct("<4sHH")          # magic, version, n_arrays
_ARRAY_HEADER = struct.Struct("<HBB")     # name_len, dtype code, ndim

#: dtype code space (u8).  Codes are part of the wire contract — append,
#: never renumber.
DTYPE_CODES = {
    np.dtype(np.float32): 1,
    np.dtype(np.float64): 2,
    np.dtype(np.float16): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int64): 5,
    np.dtype(np.uint8): 6,
    np.dtype(np.bool_): 7,
}
_CODE_DTYPES = {code: dt for dt, code in DTYPE_CODES.items()}

#: sanity bound on dims per array (a garbled ndim byte must not drive a
#: 255-iteration shape read off plausible data)
_MAX_NDIM = 8


class WireError(ValueError):
    """Malformed binary message (bad magic, bad dtype, truncated header,
    torn body).  The server answers 400 — a hostile or corrupt body must
    never crash a handler."""


class WireVersionError(WireError):
    """Well-formed framing but a protocol version this decoder does not
    speak.  The server answers 415; clients downgrade to JSON on it."""


def encode_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    """Encode named arrays into one binary message (see module doc for the
    framing).  Arrays are emitted C-contiguous; field order is preserved."""

    parts: List[bytes] = [_HEADER.pack(_MAGIC, WIRE_VERSION, len(arrays))]
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        code = DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise WireError(f"dtype {arr.dtype} has no wire code "
                            f"(supported: {sorted(map(str, DTYPE_CODES))})")
        if arr.ndim > _MAX_NDIM:
            raise WireError(f"array {name!r} has {arr.ndim} dims "
                            f"(wire cap: {_MAX_NDIM})")
        name_b = name.encode("utf-8")
        parts.append(_ARRAY_HEADER.pack(len(name_b), code, arr.ndim))
        parts.append(name_b)
        parts.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        parts.append(arr.tobytes())
    return b"".join(parts)


def decode_arrays(buf: bytes) -> Dict[str, np.ndarray]:
    """Decode one binary message into ``{name: array}``.

    Array payloads are **zero-copy** ``np.frombuffer`` views into ``buf``
    (read-only — callers that mutate must copy; the serving ingest path
    only concatenates/uploads, which copies anyway).  Raises
    :class:`WireError` on any malformation, :class:`WireVersionError` on a
    version mismatch.
    """

    buf = memoryview(bytes(buf) if not isinstance(buf, (bytes, bytearray,
                                                        memoryview))
                     else buf)
    if len(buf) < _HEADER.size:
        raise WireError(f"truncated header: {len(buf)} bytes "
                        f"(need {_HEADER.size})")
    magic, version, n_arrays = _HEADER.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise WireError(f"bad magic {bytes(magic)!r} (expected {_MAGIC!r})")
    if version != WIRE_VERSION:
        raise WireVersionError(
            f"wire version {version} not supported "
            f"(this build speaks v{WIRE_VERSION})")
    offset = _HEADER.size
    out: Dict[str, np.ndarray] = {}
    for _ in range(n_arrays):
        if offset + _ARRAY_HEADER.size > len(buf):
            raise WireError("truncated array header")
        name_len, code, ndim = _ARRAY_HEADER.unpack_from(buf, offset)
        offset += _ARRAY_HEADER.size
        if ndim > _MAX_NDIM:
            raise WireError(f"array has {ndim} dims (wire cap: {_MAX_NDIM})")
        if offset + name_len + 4 * ndim > len(buf):
            raise WireError("truncated array name/shape")
        name = bytes(buf[offset:offset + name_len]).decode("utf-8", "replace")
        offset += name_len
        shape = struct.unpack_from(f"<{ndim}I", buf, offset)
        offset += 4 * ndim
        dtype = _CODE_DTYPES.get(code)
        if dtype is None:
            raise WireError(f"unknown dtype code {code} for array {name!r}")
        count = 1
        for dim in shape:
            count *= int(dim)
        nbytes = count * dtype.itemsize
        if offset + nbytes > len(buf):
            raise WireError(
                f"torn body: array {name!r} needs {nbytes} payload bytes, "
                f"{len(buf) - offset} remain")
        out[name] = np.frombuffer(buf, dtype=dtype, count=count,
                                  offset=offset).reshape(shape)
        offset += nbytes
    if offset != len(buf):
        raise WireError(f"{len(buf) - offset} trailing bytes after the "
                        f"declared arrays")
    return out


# --------------------------------------------------------------------- #
# request / response payload helpers


def encode_request(instance: np.ndarray,
                   model_id: Optional[str] = None) -> bytes:
    """Binary /explain request body: the instance rows as float32, plus
    an optional ``model`` field (utf-8 bytes as a u8 array) naming the
    registry tenant the request targets — the wire twin of the
    ``X-DKS-Model`` header / JSON ``model`` key.  Decoders without
    registry support ignore the extra field, so the framing is
    backward-compatible."""

    arr = np.atleast_2d(np.asarray(instance, dtype=np.float32))
    arrays = {"array": arr}
    if model_id:
        arrays["model"] = np.frombuffer(model_id.encode("utf-8"),
                                        dtype=np.uint8)
    return encode_arrays(arrays)


def decode_request_meta(body: bytes):
    """``(array, model_id)`` for a binary /explain request —
    ``model_id`` is ``None`` when the body names no tenant."""

    arrays = decode_arrays(body)
    if "array" not in arrays:
        raise WireError("binary request carries no 'array' field")
    model_id = None
    if "model" in arrays:
        field = np.asarray(arrays["model"])
        if field.dtype != np.uint8 or field.ndim != 1:
            raise WireError(
                f"'model' field must be a 1-D u8 utf-8 string, got "
                f"{field.dtype} with shape {field.shape}")
        model_id = field.tobytes().decode("utf-8", "replace")
    return _check_instances(arrays["array"]), model_id


def decode_request(body: bytes) -> np.ndarray:
    """Decode a binary /explain request body into the ``(B, D)`` float32
    instance array — a zero-copy view when the body already carries
    float32 (the client encoder always does)."""

    return decode_request_meta(body)[0]


def _check_instances(arr: np.ndarray) -> np.ndarray:
    if not np.issubdtype(arr.dtype, np.floating) and \
            not np.issubdtype(arr.dtype, np.integer):
        raise WireError(f"instance rows must be numeric, got {arr.dtype}")
    arr = np.atleast_2d(arr)
    if arr.ndim != 2:
        raise WireError(f"instance rows must be 2-D, got shape {arr.shape}")
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr


def encode_explanation(shap_values, expected_value, raw_prediction,
                       interaction_values=None) -> bytes:
    """Binary /explain response body.

    ``shap_values`` is the per-class list of ``(B, M)`` arrays (or one
    array for scalar-output models) — packed as one ``(K, B, M)`` float32
    tensor; ``expected_value`` is ``(K,)``; ``raw_prediction`` ``(B, K)``
    in link space.  ``interaction_values`` (exact TreeSHAP deployments)
    packs as ``(K, B, M, M)`` when present.  This is the full numeric
    content of the Explanation JSON's hot fields — metadata stays with the
    deployment, not on every response.
    """

    sv = shap_values if isinstance(shap_values, (list, tuple)) \
        else [shap_values]
    arrays = {
        "shap_values": np.stack([np.atleast_2d(np.asarray(v, np.float32))
                                 for v in sv]),
        "expected_value": np.atleast_1d(
            np.asarray(expected_value, np.float32)),
        "raw_prediction": np.atleast_2d(
            np.asarray(raw_prediction, np.float32)),
    }
    if interaction_values is not None:
        arrays["interaction_values"] = np.stack(
            [np.asarray(v, np.float32) for v in interaction_values])
    return encode_arrays(arrays)


def decode_explanation(body: bytes) -> Dict[str, np.ndarray]:
    """Decode a binary /explain response into
    ``{'shap_values': [K x (B, M)], 'expected_value': (K,),
    'raw_prediction': (B, K)[, 'interaction_values': [K x (B, M, M)]]}``
    — the same structure :func:`explanation_payload_from_json` extracts
    from a JSON response, so callers are transport-agnostic."""

    arrays = decode_arrays(body)
    for key in ("shap_values", "expected_value", "raw_prediction"):
        if key not in arrays:
            raise WireError(f"binary response carries no {key!r} field")
    out = {
        "shap_values": [np.asarray(v) for v in arrays["shap_values"]],
        "expected_value": np.asarray(arrays["expected_value"]),
        "raw_prediction": np.asarray(arrays["raw_prediction"]),
    }
    if "interaction_values" in arrays:
        out["interaction_values"] = [np.asarray(v)
                                     for v in arrays["interaction_values"]]
    return out


def explanation_payload_from_json(payload: str) -> Dict[str, np.ndarray]:
    """Extract the :func:`decode_explanation` structure from a JSON
    Explanation payload (``interface.Explanation.to_json`` schema) — the
    client's downgrade path, so binary-mode callers get one return shape
    whatever transport the negotiation landed on."""

    import json

    doc = json.loads(payload)
    data = doc["data"]
    sv = data["shap_values"]
    if sv and not isinstance(sv[0], (list, tuple)):
        sv = [sv]
    out = {
        "shap_values": [np.asarray(v, dtype=np.float32) for v in sv],
        "expected_value": np.atleast_1d(
            np.asarray(data["expected_value"], dtype=np.float32)),
        "raw_prediction": np.atleast_2d(np.asarray(
            data["raw"]["raw_prediction"], dtype=np.float32)),
    }
    iv = data.get("raw", {}).get("interaction_values")
    if iv is not None:
        out["interaction_values"] = [np.asarray(v, dtype=np.float32)
                                     for v in iv]
    return out


# --------------------------------------------------------------------- #
# HTTP content negotiation


def is_wire_content_type(content_type: Optional[str]) -> bool:
    """Whether a ``Content-Type`` header declares a binary body (media
    type match; parameters like charset are ignored)."""

    if not content_type:
        return False
    return content_type.split(";", 1)[0].strip().lower() == CONTENT_TYPE


def accepts_wire(accept: Optional[str]) -> bool:
    """Whether an ``Accept`` header asks for a binary response.  Only an
    EXPLICIT ``application/x-dks-wire`` entry counts — ``*/*`` (and no
    header at all) keeps the historical JSON, so old clients that send a
    wildcard Accept never get bytes they cannot parse."""

    if not accept:
        return False
    for part in accept.split(","):
        if part.split(";", 1)[0].strip().lower() == CONTENT_TYPE:
            return True
    return False


# --------------------------------------------------------------------- #
# anytime streaming: versioned round frames (ISSUE 16)
#
# A streaming /explain response is a sequence of self-delimiting frames,
# one per refinement round, each wrapping a complete v1 DKSW message::
#
#     stream  := frame+
#     frame   := magic(4s="DKSS") version(u16) flags(u16) length(u32)
#                payload(length bytes, a DKSW message)
#
# flags bit 0 (:data:`STREAM_FLAG_FINAL`) marks the last frame; exactly
# one frame per stream sets it.  The payload is a standard explanation
# message (encode_explanation arrays) plus three anytime fields:
# ``round`` (i32 scalar), ``converged`` (u8 scalar), ``est_err``
# ((B, M) f32 calibrated per-feature error bars).  Reusing the DKSW
# framing inside the envelope keeps one array codec: a client that can
# read responses can read frames.
#
# Negotiation: clients ask with ``Accept: application/x-dks-wire-stream,
# application/x-dks-wire``.  A pre-anytime server matches only the plain
# wire entry and answers one ordinary binary response — the graceful
# downgrade the client is built for — while an anytime server answers
# ``Content-Type: application/x-dks-wire-stream`` with chunked frames.
# ``accepts_wire`` deliberately does NOT match the stream media type, so
# the two capabilities negotiate independently.

#: media type of a streamed (multi-frame) response
STREAM_CONTENT_TYPE = "application/x-dks-wire-stream"
#: stream envelope version (independent of :data:`WIRE_VERSION`)
STREAM_VERSION = 1
#: flags bit marking the final frame of a stream
STREAM_FLAG_FINAL = 0x1

_STREAM_MAGIC = b"DKSS"
_STREAM_HEADER = struct.Struct("<4sHHI")  # magic, version, flags, length
#: cap on a single frame payload (64 MiB) — a garbled length field must
#: not drive a multi-gigabyte allocation before the magic check fails
_MAX_FRAME_BYTES = 64 << 20


def accepts_stream(accept: Optional[str]) -> bool:
    """Whether an ``Accept`` header asks for a streamed response (explicit
    ``application/x-dks-wire-stream`` entry only, same rules as
    :func:`accepts_wire`)."""

    if not accept:
        return False
    for part in accept.split(","):
        if part.split(";", 1)[0].strip().lower() == STREAM_CONTENT_TYPE:
            return True
    return False


def encode_round_frame(shap_values, expected_value, raw_prediction,
                       round_index: int, est_err, *,
                       final: bool = False) -> bytes:
    """One stream frame for refinement round ``round_index``: a full
    explanation payload (every frame is independently usable — a client
    that stops listening keeps the best answer it saw) plus the anytime
    fields.  ``final=True`` sets :data:`STREAM_FLAG_FINAL`."""

    payload = bytearray(encode_explanation(shap_values, expected_value,
                                           raw_prediction))
    # append the anytime fields as extra arrays in the same DKSW message:
    # splice by rewriting n_arrays in the header, then extending the body
    extra = {
        "round": np.asarray([round_index], dtype=np.int32),
        "converged": np.asarray([1 if final else 0], dtype=np.uint8),
        "est_err": np.atleast_2d(np.asarray(est_err, dtype=np.float32)),
    }
    magic, version, n_arrays = _HEADER.unpack_from(payload, 0)
    tail = encode_arrays(extra)
    payload[:_HEADER.size] = _HEADER.pack(magic, version,
                                          n_arrays + len(extra))
    payload.extend(tail[_HEADER.size:])
    flags = STREAM_FLAG_FINAL if final else 0
    return _STREAM_HEADER.pack(_STREAM_MAGIC, STREAM_VERSION, flags,
                               len(payload)) + bytes(payload)


#: bytes an incremental reader must fetch before it can size a frame
STREAM_HEADER_SIZE = _STREAM_HEADER.size


def stream_frame_length(header: bytes) -> int:
    """Payload length declared by one frame's envelope header — the
    incremental reader's contract (read :data:`STREAM_HEADER_SIZE` bytes,
    call this, read exactly that many more).  Validates magic/version/cap
    with the same errors as :func:`decode_round_frame`, so a torn or
    future-version stream fails at the first header, before any payload
    bytes are waited for."""

    if len(header) < _STREAM_HEADER.size:
        raise WireError(
            f"truncated stream frame header: {len(header)} bytes "
            f"(need {_STREAM_HEADER.size})")
    magic, version, _flags, length = _STREAM_HEADER.unpack_from(header, 0)
    if magic != _STREAM_MAGIC:
        raise WireError(f"bad stream magic {bytes(magic)!r} "
                        f"(expected {_STREAM_MAGIC!r})")
    if version != STREAM_VERSION:
        raise WireVersionError(
            f"stream version {version} not supported "
            f"(this build speaks v{STREAM_VERSION})")
    if length > _MAX_FRAME_BYTES:
        raise WireError(f"stream frame declares {length} payload bytes "
                        f"(cap: {_MAX_FRAME_BYTES})")
    return int(length)


def decode_round_frame(buf, offset: int = 0):
    """Decode one frame at ``offset``.  Returns ``(frame_dict,
    next_offset)`` where ``frame_dict`` is the :func:`decode_explanation`
    structure plus ``round`` (int), ``converged`` (bool), ``est_err``
    ((B, M) f32) and ``final`` (envelope flag).  Raises
    :class:`WireError` on torn/truncated frames, :class:`WireVersionError`
    on an unknown envelope version — exactly the response-body error
    contract, so a half-written frame can never surface as phi."""

    view = memoryview(buf)
    if offset + _STREAM_HEADER.size > len(view):
        raise WireError(
            f"truncated stream frame header: {len(view) - offset} bytes "
            f"(need {_STREAM_HEADER.size})")
    magic, version, flags, length = _STREAM_HEADER.unpack_from(view, offset)
    if magic != _STREAM_MAGIC:
        raise WireError(f"bad stream magic {bytes(magic)!r} "
                        f"(expected {_STREAM_MAGIC!r})")
    if version != STREAM_VERSION:
        raise WireVersionError(
            f"stream version {version} not supported "
            f"(this build speaks v{STREAM_VERSION})")
    if length > _MAX_FRAME_BYTES:
        raise WireError(f"stream frame declares {length} payload bytes "
                        f"(cap: {_MAX_FRAME_BYTES})")
    start = offset + _STREAM_HEADER.size
    if start + length > len(view):
        raise WireError(
            f"torn stream frame: payload needs {length} bytes, "
            f"{len(view) - start} remain")
    arrays = decode_arrays(view[start:start + length])
    for key in ("shap_values", "expected_value", "raw_prediction",
                "round", "est_err"):
        if key not in arrays:
            raise WireError(f"stream frame carries no {key!r} field")
    frame = {
        "shap_values": [np.asarray(v) for v in arrays["shap_values"]],
        "expected_value": np.asarray(arrays["expected_value"]),
        "raw_prediction": np.asarray(arrays["raw_prediction"]),
        "round": int(np.asarray(arrays["round"]).reshape(-1)[0]),
        "converged": bool(np.asarray(
            arrays.get("converged", [0])).reshape(-1)[0]),
        "est_err": np.atleast_2d(np.asarray(arrays["est_err"],
                                            dtype=np.float32)),
        "final": bool(flags & STREAM_FLAG_FINAL),
    }
    return frame, start + length


def decode_round_frames(buf) -> List[Dict]:
    """Decode a complete stream body into its frames (in order).  Raises
    :class:`WireError` if the body ends mid-frame, carries trailing bytes,
    holds no frames at all, or its last frame is not marked final — a
    truncated stream must be indistinguishable from a corrupt one."""

    frames: List[Dict] = []
    offset = 0
    view = memoryview(buf)
    while offset < len(view):
        frame, offset = decode_round_frame(view, offset)
        frames.append(frame)
    if not frames:
        raise WireError("stream body holds no frames")
    if not frames[-1]["final"]:
        raise WireError("stream ended without a final frame")
    return frames
