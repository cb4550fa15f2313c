"""Pod serving fabric of the PyTorch port: the broadcast accounting only.

Port of the part of ``distributedkernelshap_tpu/serving/multihost.py`` that
the single-process server uses: the process-global broadcast meters
(reference :255-308) that ``ExplainerServer`` registers on its
``/metrics`` as ``dks_pod_bcast_bytes_total{bucket}`` /
``dks_pod_bcast_seconds_total``.  In one process nothing broadcasts, so
both read empty / zero.

The multi-host fabric itself (``MultihostServingModel``,
``PipelinedMultihostServingModel``, ``follower_loop``,
``serve_multihost``: a broadcast protocol over a ``jax.distributed`` KV
store) moves onto ``torch.distributed`` with ROADMAP.md queue A item 10;
until then those entry points raise ``NotImplementedError``.
"""

from distributedkernelshap_tpu_torch.analysis import lockwitness

_QUEUED = ("multi-host serving waits for the multi-GPU port "
           "(ROADMAP.md queue A item 10: torch.distributed)")

# ---------------------------------------------------------------------- #
# Broadcast metering.  Process-global counters with a registry callback
# (the ``attach_treeshap_metrics`` pattern): the pod model is constructed
# before the server's registry exists, and the follower side has no
# registry at all, so the counts live here and the lead's server renders
# them as ``dks_pod_bcast_bytes_total{bucket}`` /
# ``dks_pod_bcast_seconds_total``.

_pod_meter_lock = lockwitness.make_lock("multihost.pod_meter")
_pod_bcast_bytes: dict = {}
_pod_bcast_seconds: float = 0.0


def record_pod_bcast(bucket: int, nbytes: int, seconds: float) -> None:
    """Count one framed broadcast (header + bucket-padded payload)."""

    global _pod_bcast_seconds
    key = str(int(bucket))
    with _pod_meter_lock:
        _pod_bcast_bytes[key] = _pod_bcast_bytes.get(key, 0.0) + float(nbytes)
        _pod_bcast_seconds += float(seconds)


def pod_bcast_byte_counts() -> dict:
    """``{(bucket,): bytes}`` — the registry-callback shape."""

    with _pod_meter_lock:
        return {(b,): n for b, n in _pod_bcast_bytes.items()}


def pod_bcast_seconds_total() -> float:
    with _pod_meter_lock:
        return _pod_bcast_seconds


def attach_pod_metrics(registry) -> None:
    """Register the ``dks_pod_*`` broadcast meters on ``registry`` as
    callback counters over the process-global accounting.  The bucket
    label space is the broadcast ladder — bounded by construction, so no
    cardinality declaration is needed."""

    registry.counter(
        "dks_pod_bcast_bytes_total",
        "Bytes broadcast lead-to-followers on the pod serving fabric "
        "(header + payload padded to the broadcast bucket), by bucket "
        "— proportional-to-bucket by construction, vs the old "
        "protocol's every-batch full slot.",
        labelnames=("bucket",)).set_function(pod_bcast_byte_counts)
    registry.counter(
        "dks_pod_bcast_seconds_total",
        "Seconds the lead's dispatcher spent inside pod broadcast "
        "sends (header + payload, explain and warmup "
        "frames).").set_function(pod_bcast_seconds_total)


class MultihostServingModel:
    """Lead-side model of the pod fabric (ROADMAP.md queue A item 10)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_QUEUED)


def follower_loop(*args, **kwargs):
    """Follower side of the pod fabric (ROADMAP.md queue A item 10)."""

    raise NotImplementedError(_QUEUED)


def serve_multihost(*args, **kwargs):
    """Multi-host serving entry point (ROADMAP.md queue A item 10)."""

    raise NotImplementedError(_QUEUED)
