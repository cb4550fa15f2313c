"""Observability of the PyTorch port: ``tracing`` (spans with ``X-DKS-Trace``
propagation), a copy of the JAX package's framework-neutral module."""
