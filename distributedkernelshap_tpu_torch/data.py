"""Grouped-background data containers.

Copy of ``distributedkernelshap_tpu/data.py`` for the PyTorch port.

Lightweight equivalents of ``shap.common.Data`` / ``DenseData`` /
``DenseDataWithIndex`` which the reference constructs when feature grouping is
requested (``explainers/kernel_shap.py:581-671``).  They carry the background
matrix together with group names, per-group column indices and optional
per-row weights; the explain engine consumes them directly.
"""

from typing import List, Optional, Sequence

import numpy as np


class Data:
    """Marker base class (parity with ``shap.common.Data``)."""


class DenseData(Data):
    """Dense background data with optional grouping and row weights.

    Parameters
    ----------
    data
        ``(N, D)`` background matrix (rows = samples).
    group_names
        One name per feature group.
    groups
        Per-group column-index lists; defaults to singleton groups (one per
        column, in which case ``len(group_names)`` must equal ``D``).
    weights
        Per-row weights; default uniform.  Normalised to sum to 1.
    """

    def __init__(self,
                 data: np.ndarray,
                 group_names: Sequence[str],
                 groups: Optional[List[Sequence[int]]] = None,
                 weights: Optional[np.ndarray] = None):
        data = np.atleast_2d(np.asarray(data))
        if groups is None:
            groups = [[i] for i in range(data.shape[1])]
        groups = [list(g) for g in groups]

        covered = sorted(i for g in groups for i in g)
        if covered != list(range(data.shape[1])):
            raise ValueError(
                f"groups must partition the {data.shape[1]} data columns; covered {len(covered)}"
            )
        if len(group_names) != len(groups):
            raise ValueError(
                f"Expected {len(groups)} group names, got {len(group_names)}"
            )

        if weights is None:
            weights = np.ones(data.shape[0], dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        if weights.shape[0] != data.shape[0]:
            raise ValueError(
                f"Expected one weight per background row ({data.shape[0]}), got {weights.shape[0]}"
            )

        self.data = data
        self.group_names = list(group_names)
        self.groups = groups
        self.weights = weights / weights.sum()
        self.transposed = False

    @property
    def group_size(self) -> int:
        return len(self.groups)


class DenseDataWithIndex(DenseData):
    """DenseData carrying a row index (built from indexed DataFrames,
    reference ``kernel_shap.py:638-644``)."""

    def __init__(self, data, group_names, index, index_name, groups=None, weights=None):
        super().__init__(data, group_names, groups=groups, weights=weights)
        self.index = index
        self.index_name = index_name
