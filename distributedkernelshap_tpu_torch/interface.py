"""Explainer / Explanation API surface.

Copy of ``distributedkernelshap_tpu/interface.py`` for the PyTorch port (the
JAX package's ``__init__`` imports JAX, so the port keeps its own copy): the
alibi-style explainer contract found in the reference
(``explainers/interface.py:14-163``): an ``Explainer`` ABC with a ``meta``
dictionary, a ``FitMixin``, and an ``Explanation`` container exposing
``meta``/``data`` keys as attributes with a JSON round-trip.  The schema keys
below match the reference byte-for-byte (``interface.py:14-37``) so downstream
consumers (serving wire format, notebooks) translate mechanically.
"""

import abc
import copy
import json
import logging
import warnings

from collections import ChainMap
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

# Default KernelSHAP metadata (reference interface.py:14-20).
DEFAULT_META_KERNEL_SHAP = {
    "name": None,
    "type": ["blackbox"],
    "task": None,
    "explanations": ["local", "global"],
    "params": {},
}  # type: dict

# Default KernelSHAP data schema (reference interface.py:25-37).
DEFAULT_DATA_KERNEL_SHAP = {
    "shap_values": [],
    "expected_value": [],
    "link": "identity",
    "categorical_names": {},
    "feature_names": [],
    "raw": {
        "raw_prediction": None,
        "prediction": None,
        "instances": None,
        "importances": {},
    },
}  # type: dict

# Generic default metadata (reference interface.py:46-51).
DEFAULT_META = {
    "name": None,
    "type": [],
    "explanations": [],
    "params": {},
}  # type: dict


class Explainer(abc.ABC):
    """Base class for explainer algorithms (reference interface.py:55-72)."""

    def __init__(self, meta: dict = None):
        # deepcopy either way: a caller-supplied dict (often one of the
        # module-level DEFAULT_* constants) must not be mutated in place
        self.meta = copy.deepcopy(DEFAULT_META if meta is None else meta)
        # record the concrete class name and expose meta keys as attributes
        self.meta["name"] = self.__class__.__name__
        for key, value in self.meta.items():
            setattr(self, key, value)

    @abc.abstractmethod
    def explain(self, X: Any) -> "Explanation":
        pass

    def __repr__(self):
        return f"{self.__class__.__name__}(meta={self.meta!r})"


class FitMixin(abc.ABC):
    """Mixin marking explainers that require a fit step (reference interface.py:75-78)."""

    @abc.abstractmethod
    def fit(self, X: Any) -> "Explainer":
        pass


class Explanation:
    """Explanation container returned by explainers (reference interface.py:82-137).

    ``meta`` and ``data`` keys are exposed as attributes; ``to_json`` /
    ``from_json`` round-trip the payload with numpy-aware encoding.
    """

    def __init__(self, meta: dict, data: dict):
        self.meta = meta
        self.data = data
        for key, value in ChainMap(self.meta, self.data).items():
            setattr(self, key, value)

    def to_json(self) -> str:
        """Serialize the explanation data and metadata into json."""
        return json.dumps({"meta": self.meta, "data": self.data}, cls=NumpyEncoder)

    @classmethod
    def from_json(cls, jsonrepr) -> "Explanation":
        """Rebuild an Explanation from its json representation."""
        dictrepr = json.loads(jsonrepr)
        try:
            meta = dictrepr["meta"]
            data = dictrepr["data"]
        except KeyError as e:
            logger.exception("Invalid explanation representation")
            raise ValueError(f"Invalid explanation representation: missing {e}") from e
        return cls(meta=meta, data=data)

    def __getitem__(self, item):
        """Deprecated dict-style access (reference interface.py:128-137)."""
        msg = (
            "The Explanation object is not a dictionary anymore and accessing elements "
            "should be done via attribute access. Accessing via item will stop working "
            "in a future version."
        )
        warnings.warn(msg, DeprecationWarning, stacklevel=2)
        return getattr(self, item)

    def __repr__(self):
        return f"Explanation(meta={self.meta!r}, data_keys={list(self.data)!r})"


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder handling numpy scalars/arrays and torch tensors.

    Reference ``interface.py:140-163``; extended to accept torch tensors on
    any device and any object with an ``__array__`` protocol, so device arrays
    serialise without an explicit copy to numpy at every call site.
    """

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if hasattr(obj, "detach"):  # torch.Tensor, on any device
            return obj.detach().cpu().tolist()
        if hasattr(obj, "__array__"):
            return np.asarray(obj).tolist()
        return json.JSONEncoder.default(self, obj)
