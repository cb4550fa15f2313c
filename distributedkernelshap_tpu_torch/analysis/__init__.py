"""Runtime lock witness and the concurrency analyzer of the PyTorch port
(port of ``distributedkernelshap_tpu/analysis/``).

* :mod:`.core` — the finding record, pragma and baseline plumbing;
* :mod:`.concurrency` (``DKS-C0xx``) — shared-attribute races, unlocked
  container iteration, lock-order cycles, blocking calls under a lock,
  unguarded thread loops;
* :mod:`.lockwitness` — a TSan-lite runtime witness over the named
  control-plane locks (opt-in via ``DKS_LOCK_WITNESS=1``).

The JAX-contract and serving-ladder analyzers (``jax_contract``,
``ladder``) wait for ROADMAP.md queue A item 12d.
"""

# Deliberately import-light: production modules import
# `analysis.lockwitness` for their named locks, so this package __init__
# must not drag the ast-based analyzer modules into the serving path.
from distributedkernelshap_tpu_torch.analysis import lockwitness  # noqa: F401
