#!/usr/bin/env python3
"""Write the composite-model parity fixture: scikit-learn compositions, an
SVM and a Gaussian classifier fitted on the Adult-schema rows, with
scikit-learn's own outputs and the JAX package's phi, for ``chip_smoke.py``
(phase 33) and ``tests/test_torch_port_compose.py`` to rebuild the models
from their fitted attributes (stand-in estimators, numpy only) and hold the
PyTorch port against.

    python3 scripts/make_compose_parity_fixture.py [--out tests/fixtures/compose_parity.npz]

Inputs (made on first use by ``scripts/process_adult_data.py``; no
download): ``data/adult_processed.pkl`` and ``data/adult_background.pkl``.
The rows are the generated Adult-schema lookalike (``provenance ==
'synthetic'``), not UCI Adult.

Contents, each model fitted on the training rows (the SVC on the first
``N_SVC_ROWS``), with its outputs on the first ``N_ROWS`` test rows and the
JAX package's ``KernelShap(method, link, seed=0)`` phi there (background:
the 100 Adult background rows, the 12 Adult groups):

* ``pipe_*``: ``Pipeline(StandardScaler, LogisticRegression)``
  ``predict_proba``, logit link — the scaler's ``mean_`` / ``scale_``, the
  LR's ``coef_`` / ``intercept_``;
* ``svc_*``: ``SVC(kernel='rbf')`` ``decision_function``, identity link —
  ``support_vectors_``, ``dual_coef_``, ``intercept_``, ``_gamma``;
* ``cal_*``: ``CalibratedClassifierCV(LinearSVC, method='isotonic', cv=3)``
  ``predict_proba``, identity link (isotonic maps reach 0 and 1) — per
  fold the ``LinearSVC``'s ``coef_`` / ``intercept_`` and the isotonic
  ``X_thresholds_`` / ``y_thresholds_`` (concatenated, with their lengths);
* ``nb_*``: ``GaussianNB`` ``predict_proba``, identity link — ``theta_``,
  ``var_``, ``class_prior_``.

Each model's ``*_out`` is scikit-learn's output, ``*_phi`` the JAX phi
``(N_ROWS, K, M)``, ``*_expected`` E and ``*_raw`` f(x) in link space.
"""

import argparse
import os
import sys
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "compose_parity.npz")
N_ROWS, N_SVC_ROWS = 64, 1000


def _explain(method, link, bg, Xe, gn, groups):
    from distributedkernelshap_tpu import KernelShap

    ex = KernelShap(method, link=link, seed=0)
    ex.fit(bg, group_names=gn, groups=groups)
    expl = ex.explain(Xe, silent=True)
    sv = expl.shap_values
    phi = np.stack([np.asarray(v, np.float32) for v in (sv if isinstance(sv, list) else [sv])],
                   1)
    return {"phi": phi, "expected": np.asarray(expl.expected_value, np.float32).reshape(-1),
            "raw": np.asarray(expl.data["raw"]["raw_prediction"], np.float32),
            "lifted": type(ex._explainer.predictor).__name__}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import scipy.sparse as sp
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.linear_model import LogisticRegression
    from sklearn.naive_bayes import GaussianNB
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC, LinearSVC

    from distributedkernelshap_tpu.utils import data_provenance, load_data

    data = load_data()
    gn, groups = data["all"]["group_names"], data["all"]["groups"]
    Xtr = np.asarray(data["all"]["X"]["processed"]["train"].toarray(), np.float64)
    ytr = data["all"]["y"]["train"].astype(int)
    Xe = np.ascontiguousarray(data["all"]["X"]["processed"]["test"][:N_ROWS].toarray(),
                              dtype=np.float32)
    bgd = data["background"]["X"]["preprocessed"]
    bg = np.asarray(bgd.toarray() if sp.issparse(bgd) else bgd, dtype=np.float32)
    X64 = Xe.astype(np.float64)

    out = {"provenance": np.asarray(data_provenance(data)), "X": Xe, "background": bg,
           "group_widths": np.asarray([len(g) for g in groups], np.int64)}
    lifted = {}

    pipe = Pipeline([("sc", StandardScaler()),
                     ("lr", LogisticRegression(max_iter=500))]).fit(Xtr, ytr)
    sc, lr = pipe.named_steps["sc"], pipe.named_steps["lr"]
    out.update(pipe_mean=sc.mean_, pipe_scale=sc.scale_, pipe_coef=lr.coef_,
               pipe_intercept=lr.intercept_, pipe_out=pipe.predict_proba(X64))
    res = _explain(pipe.predict_proba, "logit", bg, Xe, gn, groups)

    svc = SVC(kernel="rbf").fit(Xtr[:N_SVC_ROWS], ytr[:N_SVC_ROWS])
    out.update(svc_sv=svc.support_vectors_, svc_dual=svc.dual_coef_[0],
               svc_intercept=svc.intercept_, svc_gamma=np.asarray(svc._gamma),
               svc_out=svc.decision_function(X64))
    results = {"pipe": res, "svc": _explain(svc.decision_function, "identity", bg, Xe, gn,
                                            groups)}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cal = CalibratedClassifierCV(LinearSVC(), method="isotonic", cv=3).fit(Xtr, ytr)
    folds = cal.calibrated_classifiers_
    out.update(
        cal_coef=np.concatenate([f.estimator.coef_ for f in folds]),
        cal_intercept=np.concatenate([f.estimator.intercept_ for f in folds]),
        cal_x=np.concatenate([f.calibrators[0].X_thresholds_ for f in folds]),
        cal_y=np.concatenate([f.calibrators[0].y_thresholds_ for f in folds]),
        cal_len=np.asarray([f.calibrators[0].X_thresholds_.shape[0] for f in folds]),
        cal_out=cal.predict_proba(X64))
    results["cal"] = _explain(cal.predict_proba, "identity", bg, Xe, gn, groups)

    nb = GaussianNB().fit(Xtr, ytr)
    out.update(nb_theta=nb.theta_, nb_var=nb.var_, nb_prior=nb.class_prior_,
               nb_out=nb.predict_proba(X64))
    results["nb"] = _explain(nb.predict_proba, "identity", bg, Xe, gn, groups)

    for name, res in results.items():
        lifted[name] = res.pop("lifted")
        out.update({f"{name}_{k}": v for k, v in res.items()})
        out[f"{name}_lifted"] = np.asarray(lifted[name])

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes, provenance "
          f"{out['provenance']}, X {Xe.shape}, support vectors {out['svc_sv'].shape}, "
          f"isotonic thresholds {out['cal_len'].tolist()}, lifted {lifted}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
