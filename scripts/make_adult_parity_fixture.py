#!/usr/bin/env python3
"""Write the Adult parity fixture: the JAX package's own answers on the
Adult-schema synthetic rows, for ``chip_smoke.py`` to hold the PyTorch
port's answers on the card against (reading the file with numpy only).

    python3 scripts/make_adult_parity_fixture.py [--out tests/fixtures/adult_parity.npz]

Inputs (made on first use by ``scripts/process_adult_data.py`` and
``scripts/fit_adult_model.py``; no download): ``data/adult_processed.pkl``,
``data/adult_background.pkl`` and ``assets/predictor.pkl``.  The rows are
the generated Adult-schema lookalike (``provenance == 'synthetic'``), not
UCI Adult.

Contents:

* the headline task (``bench.py``): the 2560 test rows, the 100 background
  rows, the 12 group widths, the logistic regression's ``coef_`` and
  ``intercept_``, and the JAX package's phi ``(B, K, M)``, E ``(K,)`` and
  f(x) ``(B, K)`` in logit space
  (``KernelShap(clf.predict_proba, link='logit', seed=0)``);
* the ``adult_trees_exact`` GBT (``benchmarks/configs.py:240-282``, a
  ``HistGradientBoostingRegressor`` of 50 iterations) as the node tables
  the JAX package lifts it to (``feature``, ``threshold``, ``left``,
  ``right``, ``value``, ``missing_left``, ``base``, ``depth``), with the JAX
  exact phi ``(256, M)``, E and the interaction matrices ``(256, M, M)`` on
  the first 256 rows.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "adult_parity.npz")
N_TREE_ROWS = 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import scipy.sparse as sp
    from sklearn.ensemble import HistGradientBoostingRegressor

    from distributedkernelshap_tpu import KernelShap
    from distributedkernelshap_tpu.models import TreeEnsemblePredictor
    from distributedkernelshap_tpu.utils import data_provenance, load_data, load_model

    data = load_data()
    clf = load_model()
    gn, groups = data["all"]["group_names"], data["all"]["groups"]
    X = np.ascontiguousarray(data["all"]["X"]["processed"]["test"].toarray(),
                             dtype=np.float32)
    bgd = data["background"]["X"]["preprocessed"]
    bg = np.asarray(bgd.toarray() if sp.issparse(bgd) else bgd, dtype=np.float32)

    lr = KernelShap(clf.predict_proba, link="logit", feature_names=gn, seed=0)
    lr.fit(bg, group_names=gn, groups=groups)
    expl = lr.explain(X, silent=True)

    Xtr = data["all"]["X"]["processed"]["train"].toarray()
    ytr = data["all"]["y"]["train"].astype(np.float64)
    gbr = HistGradientBoostingRegressor(max_iter=50, random_state=0).fit(Xtr, ytr)
    tree = KernelShap(gbr.predict, seed=0)
    tree.fit(bg, group_names=gn, groups=groups)
    pred = tree._explainer.predictor
    assert isinstance(pred, TreeEnsemblePredictor)
    expl_t = tree.explain(X[:N_TREE_ROWS], nsamples="exact", interactions=True, silent=True)

    out = {
        "provenance": np.asarray(data_provenance(data)),
        "X": X, "background": bg,
        "group_widths": np.asarray([len(g) for g in groups], np.int64),
        "coef": np.asarray(clf.coef_, np.float32),
        "intercept": np.asarray(clf.intercept_, np.float32),
        "phi": np.stack([np.asarray(v, np.float32) for v in expl.shap_values], 1),
        "expected_value": np.asarray(expl.expected_value, np.float32),
        "raw_prediction": np.asarray(expl.data["raw"]["raw_prediction"], np.float32),
        "tree_feature": np.asarray(pred.feature, np.int32),
        "tree_threshold": np.asarray(pred.threshold, np.float32),
        "tree_left": np.asarray(pred.left, np.int32),
        "tree_right": np.asarray(pred.right, np.int32),
        "tree_value": np.asarray(pred.value, np.float32),
        "tree_missing_left": np.asarray(pred.missing_left, bool),
        "tree_base": np.asarray(pred.base, np.float32),
        "tree_scale": np.asarray(pred.scale, np.float32),
        "tree_depth": np.asarray(pred.depth, np.int64),
        "tree_phi": np.asarray(expl_t.shap_values[0], np.float32),
        "tree_expected_value": np.asarray(expl_t.expected_value, np.float32).reshape(-1),
        "tree_interactions": np.asarray(expl_t.data["raw"]["interaction_values"][0],
                                        np.float32),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, provenance "
          f"{out['provenance']}, X {X.shape}, phi {out['phi'].shape}, trees "
          f"{out['tree_feature'].shape}, tree phi {out['tree_phi'].shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
