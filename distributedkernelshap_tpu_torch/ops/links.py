"""Link functions (port of ``distributedkernelshap_tpu/ops/links.py``).

The reference delegates to ``shap.common.convert_to_link`` (used at
``explainers/kernel_shap.py:949``) supporting ``'identity'`` and ``'logit'``.
Here the links are torch functions applied on the device; ``logit`` clips
probabilities away from {0,1} with the JAX package's ``1e-7`` so float32
arithmetic never produces inf.  The numpy variants serve host-side callers.
"""

import numpy as np
import torch

_LOGIT_EPS = 1e-7


def identity_link(x):
    return x


def logit_link(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, _LOGIT_EPS, 1.0 - _LOGIT_EPS)
    return torch.log(p / (1.0 - p))


_LINKS = {"identity": identity_link, "logit": logit_link}


def identity_link_np(x):
    return x


def logit_link_np(p):
    p = np.clip(p, _LOGIT_EPS, 1.0 - _LOGIT_EPS)
    return np.log(p / (1.0 - p))


_LINKS_NP = {"identity": identity_link_np, "logit": logit_link_np}


def _lookup(table, link):
    if callable(link):
        return link
    try:
        return table[link]
    except KeyError:
        raise ValueError(f"link must be one of {sorted(table)} or a callable, got {link!r}")


def convert_to_link(link):
    """Map a link name (or callable) to a torch function
    (parity with shap.common.convert_to_link semantics)."""

    return _lookup(_LINKS, link)


def convert_to_link_np(link):
    """Numpy variant for host-side evaluation paths."""

    return _lookup(_LINKS_NP, link)
