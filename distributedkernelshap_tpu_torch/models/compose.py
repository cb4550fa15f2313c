"""Composite predictors.

Port of ``distributedkernelshap_tpu/models/compose.py``, for now only
:class:`AffineOutputPredictor` (reference ``:601-625``), the head that the
IsolationForest lift's ``decision_function`` rides and that the exact
TreeSHAP path unwraps (``ops/treeshap._unwrap``).  The rest of the module
(pipelines, voting, bagging, stacking, one-vs-rest, calibrated and
search-CV estimators, AdaBoost, the transformed-target lift) is ROADMAP.md
queue A item 9.
"""

import torch

from distributedkernelshap_tpu_torch.models.predictors import BasePredictor


class AffineOutputPredictor(BasePredictor):
    """Inner predictor outputs mapped through ``y -> a*y + b`` (e.g. a
    target scaler's inverse transform, IsolationForest's decision offset).
    Expectation is linear, so the inner model's structure-aware masked
    evaluation forwards through the head.  ``a`` and ``b`` are floats; the
    inner predictor is a submodule, so ``.to(device)`` moves it."""

    def __init__(self, inner: BasePredictor, a: float, b: float):
        super().__init__()
        self.inner = inner
        self.a = float(a)
        self.b = float(b)
        self.n_outputs = inner.n_outputs
        self.vector_out = inner.vector_out

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.inner(X) * self.a + self.b

    @property
    def supports_masked_ey(self) -> bool:
        return getattr(self.inner, "supports_masked_ey", False)

    def masked_ey_fits(self, **kwargs) -> bool:
        return self.inner.masked_ey_fits(**kwargs)

    def masked_ey(self, *args, **kwargs):
        return self.inner.masked_ey(*args, **kwargs) * self.a + self.b
