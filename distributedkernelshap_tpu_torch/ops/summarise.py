"""Background-set summarisation: subsampling and weighted k-means.

Copy of ``distributedkernelshap_tpu/ops/summarise.py`` for the PyTorch port;
scikit-learn is imported only when k-means runs.

The reference delegates to ``shap.sample`` / ``shap.kmeans``
(``explainers/kernel_shap.py:503-542``): random subsampling when grouping or
categorical variables are present, otherwise k-means centroids with each
coordinate snapped to the nearest observed value and clusters weighted by
occupancy.  Both run once at fit time on the host — they are not on the
device hot path, so a plain sklearn k-means is the right tool.
"""

from typing import Optional, Union

import numpy as np

from distributedkernelshap_tpu_torch.data import DenseData


def subsample(data, nsamples: int, seed: Optional[int] = None):
    """Uniform random subsample without replacement (shap.sample parity).

    The input's container type is preserved — DataFrame in, DataFrame out
    (row indexing via ``.iloc``), sparse stays sparse — so the downstream
    background-type dispatch (``kernel_shap._get_data``) fires the same
    register whether or not a reduction happened.  Uses the global numpy RNG
    when ``seed`` is None so the reference's ``np.random.seed(self.seed)``
    fit-time determinism carries over.
    """

    n = data.shape[0]
    if nsamples >= n:
        return data
    rng = np.random if seed is None else np.random.default_rng(seed)
    idx = rng.choice(n, nsamples, replace=False)
    idx.sort()
    if hasattr(data, "iloc"):  # pandas
        return data.iloc[idx]
    return data[idx]  # ndarray & scipy sparse both support row fancy-indexing


def kmeans_summary(data: Union[np.ndarray, "object"], k: int,
                   round_values: bool = True, seed: int = 0) -> DenseData:
    """Summarise ``data`` to ``k`` weighted centroids (shap.kmeans parity).

    Each centroid coordinate is snapped to the nearest actually-observed
    value in that column (so one-hot/integer columns stay valid), and each
    centroid is weighted by the number of points in its cluster.
    """

    from sklearn.cluster import KMeans

    if hasattr(data, "toarray"):
        data = data.toarray()
    data = np.asarray(data)

    km = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(data)
    centers = km.cluster_centers_.copy()

    if round_values:
        for j in range(data.shape[1]):
            col = data[:, j]
            for i in range(k):
                centers[i, j] = col[np.argmin(np.abs(col - centers[i, j]))]

    weights = np.bincount(km.labels_, minlength=k).astype(np.float64)
    group_names = [f"feature_{j}" for j in range(data.shape[1])]
    return DenseData(centers, group_names, weights=weights)
