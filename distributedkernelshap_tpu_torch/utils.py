"""Utilities: device resolution, full-precision matmuls, ``Bunch``,
``methdispatch``, the boolean env knobs, ``ensure_dir`` and the Adult
data/model loaders.

``Bunch``, ``methdispatch``, ``parse_bool_token``, ``resolve_bool_env``,
``ensure_dir``, ``load_data``, ``load_model``, ``data_provenance``,
``get_filename`` and ``batch`` are
copies of ``distributedkernelshap_tpu/utils.py``
(the JAX package's ``__init__`` imports JAX, so the port keeps its own).  The
loaders here only READ the cached pickles: they never generate the data,
because the generator scripts import the JAX package and scikit-learn.
"""

import contextlib
import logging
import os
import pickle

from functools import singledispatch, update_wrapper
from typing import Callable, List, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

# caches are anchored to the repo root (parent of this package) so behaviour
# does not depend on the caller's working directory
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPLANATIONS_SET_LOCAL = os.path.join(REPO_ROOT, "data", "adult_processed.pkl")
BACKGROUND_SET_LOCAL = os.path.join(REPO_ROOT, "data", "adult_background.pkl")
MODEL_LOCAL = os.path.join(REPO_ROOT, "assets", "predictor.pkl")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  Without a GPU and without an explicit device this
    raises — the port never carries on quietly on the CPU.  A CUDA device
    given without an index resolves to the current one, so the threads
    that serve an engine can bind it (``torch.cuda.set_device`` takes an
    index; a new thread starts on device 0)."""

    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "PyTorch port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls, einsums and cuDNN convolutions at full precision
    (TF32 off) inside the block, whatever the caller set; the caller's
    settings are back on exit.

    PyTorch's default leaves ``torch.backends.cudnn.allow_tf32`` on, so
    without this every ``F.conv2d`` on the card rounds its inputs to TF32.
    PyTorch has two APIs for each setting, and reading one after the other
    was set raises, so this keeps to the one the caller's state answers."""

    with _cudnn_f32():
        try:
            prev = torch.get_float32_matmul_precision()
        except RuntimeError:     # the caller set the per-backend API
            matmul = torch.backends.cuda.matmul
            prev = matmul.fp32_precision
            matmul.fp32_precision = "ieee"
            try:
                yield
            finally:
                matmul.fp32_precision = prev
            return
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def _cudnn_f32():
    """cuDNN convolutions in full float32 inside the block (the half of
    :func:`full_f32_matmul` that covers ``F.conv2d`` and its gradients)."""

    cudnn = torch.backends.cudnn
    try:
        prev = cudnn.allow_tf32
    except RuntimeError:         # the caller set the per-operator API
        prev = cudnn.conv.fp32_precision
        cudnn.conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            cudnn.conv.fp32_precision = prev
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def cudnn_tf32_enabled() -> bool:
    """Whether cuDNN convolutions may round float32 inputs to TF32 now,
    read through whichever API the current settings answer."""

    cudnn = torch.backends.cudnn
    try:
        return bool(cudnn.allow_tf32)
    except RuntimeError:
        return cudnn.conv.fp32_precision == "tf32"


class Bunch(dict):
    """Dictionary exposing its keys as attributes (reference utils.py:22-40)."""

    def __init__(self, **kwargs):
        super().__init__(kwargs)

    def __setattr__(self, key, value):
        self[key] = value

    def __dir__(self):
        return self.keys()

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)


def parse_bool_token(raw: Optional[str]) -> Optional[bool]:
    """The ONE truthy/falsy env-token parser shared by every boolean knob
    (``DKS_WARMUP``/``DKS_STAGING``/``DKS_DONATE``): ``True``/``False``
    for a recognised token, ``None`` for empty/unrecognised — each caller
    applies its own default (and decides whether to warn), so the token
    vocabulary can never drift between knobs."""

    raw = (raw or "").strip().lower()
    if raw in ("1", "true", "on", "yes"):
        return True
    if raw in ("0", "false", "off", "no"):
        return False
    return None


def resolve_bool_env(name: str, default: bool) -> bool:
    """Resolve one boolean env knob via :func:`parse_bool_token`.  An
    unrecognised non-empty value falls back to ``default`` LOUDLY — the
    shared contract of ``DKS_WARMUP``/``DKS_STAGING``/``DKS_DONATE``: a
    typo must never silently flip (or silently keep) a behaviour the
    operator thinks they set."""

    raw = os.environ.get(name, "")
    parsed = parse_bool_token(raw)
    if parsed is not None:
        return parsed
    if raw.strip():
        logging.getLogger(__name__).warning(
            "unrecognised %s=%r; using the component default (%s)",
            name, raw, default)
    return default


def methdispatch(func: Callable):
    """singledispatch on ``args[1]`` so it works for instance methods
    (reference utils.py:43-64)."""

    dispatcher = singledispatch(func)

    def wrapper(*args, **kw):
        return dispatcher.dispatch(args[1].__class__)(*args, **kw)

    wrapper.register = dispatcher.register
    update_wrapper(wrapper, dispatcher)
    return wrapper


def _read_pickle(path: str, script: str):
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{path} is missing; generate it with `python scripts/{script}` "
            "(needs the JAX package and scikit-learn)") from None


def load_model(path: str = MODEL_LOCAL):
    """Load the cached Adult predictor (unpickling it needs scikit-learn)."""

    return _read_pickle(path, "fit_adult_model.py")


def load_data():
    """Load the cached Adult instances to explain + background data."""

    return {
        "background": _read_pickle(BACKGROUND_SET_LOCAL, "process_adult_data.py"),
        "all": _read_pickle(EXPLANATIONS_SET_LOCAL, "process_adult_data.py"),
    }


def get_filename(workers: int, batch_size: int, cpu_fraction: float = 1.0, serve: bool = True) -> str:
    """Result-file naming convention, kept identical to the reference
    (``utils.py:67-86``) so the Analysis notebook keeps working.  ``workers``
    maps to devices or replicas."""

    if serve:
        return f"results/ray_replicas_{workers}_maxbatch_{batch_size}_actorfr_{cpu_fraction}.pkl"
    return f"results/ray_workers_{workers}_bsize_{batch_size}_actorfr_{cpu_fraction}.pkl"


def batch(X: np.ndarray, batch_size: Optional[int] = None, n_batches: int = 4) -> List[np.ndarray]:
    """Split ``X`` into mini-batches (reference ``utils.py:89-121``).

    If ``batch_size`` is given, produces ceil(n/batch_size) chunks of that
    size (last one smaller); otherwise ``n_batches`` roughly-equal parts.
    Sparse input is densified.
    """

    n_records = X.shape[0]
    if hasattr(X, "toarray"):  # scipy sparse
        X = X.toarray()

    if batch_size:
        n = n_records // batch_size
        if n_records % batch_size != 0:
            n += 1
        slices = [batch_size * i for i in range(1, n)]
        return np.array_split(X, slices)
    return np.array_split(X, n_batches)


def ensure_dir(path: str) -> None:
    """Create the parent directory of the file ``path`` (which may have no
    extension — the argument is always interpreted as a file path)."""

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def data_provenance(data: dict) -> str:
    """Which data a ``load_data()`` dict carries: ``'uci'`` (real fetch),
    ``'synthetic'`` (offline lookalike) or ``'unknown-cache'`` for cache
    files written before provenance stamping."""

    try:
        return str(data["all"].get("provenance", "unknown-cache"))
    except (KeyError, TypeError, AttributeError):
        return "unknown-cache"
