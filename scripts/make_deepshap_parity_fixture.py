#!/usr/bin/env python3
"""Write the MNIST CNN parity fixture: the JAX package's DeepSHAP and
sampled image KernelSHAP answers at the full width of ``config_mnist``
(``benchmarks/configs.py:404-452``), for ``chip_smoke.py`` (phases 37–38)
and ``tests/test_torch_port_deepshap.py`` to rebuild the CNN in the PyTorch
port and hold it against.

    python3 scripts/make_deepshap_parity_fixture.py [--out tests/fixtures/deepshap_parity.npz]

The model and data are ``config_mnist``'s smoke run: the CNN trained by
the JAX package's ``train_mnist_cnn`` (1 epoch, seed 0) on the first 4000
training rows of ``scripts/process_mnist_data.load_mnist()``, which
without a cached ``data/mnist.pkl`` generates its offline synthetic digits
(smooth class templates with jitter and noise; ``provenance ==
'synthetic'``) — not MNIST.  Explained: the first ``N_ROWS`` test images
against the mean background of the training rows (N = 1), grouped into the
49 superpixels of 4×4 (M = 49).

Contents:

* ``param/<layer>/<kernel|bias>``: the flax parameters (``Conv_i`` kernels
  HWIO, ``Dense_i`` kernels ``(in, out)``);
* ``X`` ``(N_ROWS, 784)``, ``bg`` ``(1, 784)``, ``provenance``;
* ``deep_phi`` ``(N_ROWS, 10, 49)``, ``deep_expected`` and ``deep_raw``: the
  logits head under ``nsamples='exact'`` (DeepSHAP), identity link;
* ``sampled_phi``, ``sampled_expected``, ``sampled_raw``: the probs head,
  ``link='logit'``, seed 0, default nsamples (S = 2146), ``l1_reg=False``,
  float32 transfer;
* ``accuracy``: the CNN's accuracy on the first 1000 test images.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "fixtures", "deepshap_parity.npz")
N_TRAIN, N_ROWS, PATCH = 4000, 32, 4


def _phi(expl) -> np.ndarray:
    sv = expl.shap_values
    return np.stack([np.asarray(v, np.float32) for v in sv], 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from distributedkernelshap_tpu import KernelShap
    from distributedkernelshap_tpu.models.cnn import CNNPredictor, train_mnist_cnn
    from distributedkernelshap_tpu.ops.image import image_background, superpixel_groups
    from scripts.process_mnist_data import load_mnist

    data = load_mnist()
    tr_images, tr_labels = data["train"]
    te_images, te_labels = data["test"]
    tr_images, tr_labels = tr_images[:N_TRAIN], tr_labels[:N_TRAIN]
    pred = train_mnist_cnn(tr_images, tr_labels, epochs=1, seed=0)
    acc = float((np.asarray(pred(te_images[:1000].reshape(1000, -1))).argmax(1)
                 == te_labels[:1000]).mean())
    logits = CNNPredictor(pred.params, (28, 28, 1), n_classes=10, output="logits")

    groups, names = superpixel_groups(28, 28, patch=PATCH)
    bg = image_background(tr_images, mode="mean")
    X = te_images.reshape(te_images.shape[0], -1)[:N_ROWS].astype(np.float32)

    deep = KernelShap(logits, feature_names=names, seed=0)
    deep.fit(bg, group_names=names, groups=groups)
    e_deep = deep.explain(X, nsamples="exact", silent=True)
    sampled = KernelShap(pred, link="logit", feature_names=names, seed=0)
    sampled.fit(bg, group_names=names, groups=groups)
    e_samp = sampled.explain(X, l1_reg=False, silent=True)

    out = {f"param/{layer}/{k}": np.asarray(v, np.float32)
           for layer, leaves in pred.params.items() for k, v in leaves.items()}
    out.update(
        X=X, bg=bg.astype(np.float32), provenance=np.asarray(data.get("provenance", "mnist")),
        accuracy=np.float32(acc),
        deep_phi=_phi(e_deep),
        deep_expected=np.asarray(e_deep.expected_value, np.float32),
        deep_raw=np.asarray(e_deep.data["raw"]["raw_prediction"], np.float32),
        sampled_phi=_phi(e_samp),
        sampled_expected=np.asarray(e_samp.expected_value, np.float32),
        sampled_raw=np.asarray(e_samp.data["raw"]["raw_prediction"], np.float32))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes; accuracy {acc:.3f}; "
          f"deep max|phi| {np.abs(out['deep_phi']).max():.4f} (kernel path "
          f"{deep.kernel_path}); sampled max|phi| {np.abs(out['sampled_phi']).max():.4f} "
          f"(kernel path {sampled.kernel_path})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
