"""The PyTorch port's image pieces against the JAX package, on the CPU:
``ops/image.py`` (superpixel groups, image backgrounds), ``models/cnn.py``
(the MNIST CNN, its graph export and fingerprint) with
``convert.cnn_from_numpy``, and ``utils.full_f32_matmul``'s cuDNN half.

Inputs are made from a seed with numpy, the CNN's parameters by flax's own
initialiser from ``jax.random.PRNGKey`` seeds.  Tolerances: the superpixel
groups, the backgrounds, the graph export's nodes and initializers compare
exactly; the CNN forward within 2e-5 of flax's (the reference's bar,
``tests/test_deepshap.py:334-347``), both heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedkernelshap_tpu.models.cnn import _CNN as JaxCNN
from distributedkernelshap_tpu.models.cnn import CNNPredictor as JaxCNNPredictor
from distributedkernelshap_tpu.ops import image as jimage
from distributedkernelshap_tpu_torch.convert import cnn_from_numpy
from distributedkernelshap_tpu_torch.models.cnn import CNNPredictor
from distributedkernelshap_tpu_torch.ops import image as timage
from distributedkernelshap_tpu_torch.utils import cudnn_tf32_enabled, full_f32_matmul

FORWARD_ATOL = 2e-5


@pytest.mark.parametrize("height,width,patch,channels", [
    (28, 28, 4, 1), (12, 12, 4, 1), (10, 7, 3, 1), (6, 5, 4, 3)],
    ids=["mnist", "square", "ragged", "multichannel"])
def test_superpixel_groups_equal_the_references(height, width, patch, channels):
    got = timage.superpixel_groups(height, width, patch, channels)
    assert got == jimage.superpixel_groups(height, width, patch, channels)
    flat = sorted(c for g in got[0] for c in g)
    assert flat == list(range(height * width * channels))


@pytest.mark.parametrize("mode,kw", [
    ("mean", {}), ("fill", {"fill_value": 0.25}), ("sample", {"n_rows": 3}),
    ("blur", {"blur_radius": 0, "n_rows": 2}), ("blur", {"blur_radius": 2, "n_rows": 2})],
    ids=["mean", "fill", "sample", "blur_r0", "blur_r2"])
def test_image_background_equals_the_references(mode, kw):
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, size=(5, 9, 8, 2)).astype(np.float32)
    got = timage.image_background(images, mode=mode, **kw)
    want = jimage.image_background(images, mode=mode, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if mode != "blur":
        flat = images.reshape(5, -1)
        assert np.array_equal(timage.image_background(flat, mode=mode, **kw),
                              jimage.image_background(flat, mode=mode, **kw))


def test_image_background_rejects_what_the_reference_rejects():
    flat = np.zeros((2, 16), np.float32)
    for mod in (timage, jimage):
        with pytest.raises(ValueError, match="blur mode needs"):
            mod.image_background(flat, mode="blur")
        with pytest.raises(ValueError, match="Unknown background mode"):
            mod.image_background(flat, mode="median")


def _flax_params(seed, side, K):
    params = JaxCNN(n_classes=K).init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, side, side, 1), jnp.float32))["params"]
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=[(0, 12, 4), (1, 28, 10)], ids=["12x12", "28x28"])
def cnn_pair(request):
    seed, side, K = request.param
    params, np_params = _flax_params(seed, side, K)
    heads = {out: (JaxCNNPredictor(params, (side, side, 1), n_classes=K, output=out),
                   cnn_from_numpy(np_params, (side, side, 1), K, out, device="cpu"))
             for out in ("logits", "probs")}
    X = np.random.default_rng(seed + 5).uniform(0, 1, size=(6, side * side)).astype(np.float32)
    return heads, X, np_params


@pytest.mark.parametrize("output", ["logits", "probs"])
def test_cnn_forward_matches_flax(cnn_pair, output):
    heads, X, _ = cnn_pair
    jax_pred, port = heads[output]
    with torch.no_grad():
        got = port(torch.as_tensor(X)).numpy()
    want = np.asarray(jax_pred(jnp.asarray(X)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL)
    assert port.n_outputs == jax_pred.n_outputs and port.vector_out


@pytest.mark.parametrize("output", ["logits", "probs"])
def test_cnn_graph_spec_equals_the_references(cnn_pair, output):
    heads, _, _ = cnn_pair
    jax_pred, port = heads[output]
    want, got = jax_pred.graph_spec(), port.graph_spec()
    assert [tuple(n) for n in got.nodes] == [tuple(n) for n in want.nodes]
    assert (got.input_name, got.output_name, got.input_dim) == \
        (want.input_name, want.output_name, want.input_dim)
    assert sorted(got.initializers) == sorted(want.initializers)
    for name, arr in want.initializers.items():
        assert got.initializers[name].dtype == np.asarray(arr).dtype
        assert np.array_equal(got.initializers[name], np.asarray(arr)), name
    assert port.graph_spec() is got    # cached, as the reference caches it


def test_cnn_fingerprint_separates_heads_and_parameters(cnn_pair):
    heads, _, np_params = cnn_pair
    logits, probs = heads["logits"][1], heads["probs"][1]
    assert logits.fingerprint_bytes() != probs.fingerprint_bytes()
    side, K = logits.image_shape[0], logits.n_outputs
    again = cnn_from_numpy(np_params, (side, side, 1), K, "logits", device="cpu")
    assert again.fingerprint_bytes() == logits.fingerprint_bytes()
    moved = jax.tree_util.tree_map(lambda a: a + np.float32(1e-3), np_params)
    other = cnn_from_numpy(moved, (side, side, 1), K, "logits", device="cpu")
    assert other.fingerprint_bytes() != logits.fingerprint_bytes()


def test_cnn_from_numpy_rejects_mismatched_shapes():
    _, np_params = _flax_params(0, 12, 4)
    with pytest.raises(ValueError, match="Dense_0 kernel has shape"):
        cnn_from_numpy(np_params, (28, 28, 1), 4, device="cpu")
    with pytest.raises(ValueError, match="output must be"):
        CNNPredictor(cnn_from_numpy(np_params, (12, 12, 1), 4, device="cpu").net,
                     n_classes=4, output="margins", device="cpu")


def test_full_f32_matmul_turns_cudnn_tf32_off_and_restores_it():
    """Both PyTorch APIs: the legacy ``allow_tf32`` flag and the
    per-operator ``conv.fp32_precision``; the caller's setting is back on
    exit, also when the block raises."""

    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        for start in (True, False):
            cudnn.allow_tf32 = start
            with full_f32_matmul():
                assert not cudnn_tf32_enabled() and cudnn.allow_tf32 is False
            assert cudnn.allow_tf32 is start
        cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError, match="inside"):
            with full_f32_matmul():
                raise RuntimeError("inside")
        assert cudnn.allow_tf32 is True
        # the per-operator API set by the caller, with the two flags apart
        cudnn.conv.fp32_precision = "tf32"
        cudnn.rnn.fp32_precision = "ieee"
        assert cudnn_tf32_enabled()
        with full_f32_matmul():
            assert cudnn.conv.fp32_precision == "ieee" and not cudnn_tf32_enabled()
        assert cudnn.conv.fp32_precision == "tf32"
    finally:
        cudnn.conv.fp32_precision = "tf32"
        cudnn.rnn.fp32_precision = "tf32"
        cudnn.allow_tf32 = saved
