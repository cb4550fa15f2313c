"""``models/cnn.train_mnist_cnn`` of the port against the JAX package's.

Flax and torch draw their initial parameters from different generators, so
parity is shown two ways: the reference's own test
(``tests/test_image_models.py``: 2000 synthetic digits, 1 epoch, accuracy
above 0.5 on 200 held-out digits), and one Adam step from EQUAL parameters
(``convert.cnn_from_numpy`` of the flax initialisation) against optax's
step on the same batch: every updated parameter within ``STEP_ATOL`` =
1e-6 (an update moves a parameter by about ``lr`` = 1e-3; the gradients
differ only in f32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedkernelshap_tpu.models.cnn import _CNN as JaxCNN
from distributedkernelshap_tpu_torch.convert import cnn_from_numpy
from distributedkernelshap_tpu_torch.models.cnn import (
    CNNPredictor,
    _adam_steps,
    train_mnist_cnn,
)
from scripts.process_mnist_data import _class_templates, _synthetic_digits

STEP_ATOL = 1e-6
SHAPE = (28, 28, 1)


@pytest.fixture(scope="module")
def digits():
    rng = np.random.default_rng(0)
    templates = _class_templates(rng)
    images, labels = _synthetic_digits(2000, rng, templates)
    test_imgs, test_labels = _synthetic_digits(200, rng, templates)
    return images, labels, test_imgs, test_labels


def test_one_epoch_on_2000_digits_beats_half(digits):
    images, labels, test_imgs, test_labels = digits
    pred = train_mnist_cnn(images, labels, epochs=1, batch_size=128, device="cpu")
    assert isinstance(pred, CNNPredictor) and pred.output == "probs"
    assert not any(p.requires_grad for p in pred.parameters())
    with torch.no_grad():
        probs = pred(torch.as_tensor(test_imgs.reshape(200, -1)))
    acc = float((probs.argmax(1).numpy() == test_labels).mean())
    assert acc > 0.5
    # same seed, same model: the generator and the batch order are seeded
    again = train_mnist_cnn(images, labels, epochs=1, batch_size=128, device="cpu")
    assert again.fingerprint_bytes() == pred.fingerprint_bytes()
    other = train_mnist_cnn(images[:512], labels[:512], epochs=1, batch_size=128,
                            seed=1, output="logits", device="cpu")
    assert other.output == "logits" and other.fingerprint_bytes() != pred.fingerprint_bytes()


def test_one_adam_step_matches_optax_from_equal_parameters(digits):
    images, labels, _, _ = digits
    module = JaxCNN(n_classes=10)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1,) + SHAPE))["params"]
    xb = images[:64].reshape(64, -1).astype(np.float32)
    yb = labels[:64]

    def loss_fn(p):
        logits = module.apply({"params": p}, jnp.asarray(xb).reshape((-1,) + SHAPE))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(yb)).mean()

    tx = optax.adam(1e-3)
    updates, _ = tx.update(jax.jit(jax.grad(loss_fn))(params), tx.init(params))
    stepped = optax.apply_updates(params, updates)

    def as_numpy(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    net = cnn_from_numpy(as_numpy(params), SHAPE, 10, device="cpu").net
    _adam_steps(net, [(torch.as_tensor(xb), torch.as_tensor(yb.astype(np.int64)))], 1e-3)
    want = cnn_from_numpy(as_numpy(stepped), SHAPE, 10, device="cpu").net
    start = cnn_from_numpy(as_numpy(params), SHAPE, 10, device="cpu").net
    for (name, got), ref, p0 in zip(net.named_parameters(), want.parameters(),
                                    start.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                                   atol=STEP_ATOL, err_msg=name)
        assert bool((got.detach() != p0).any()), name
