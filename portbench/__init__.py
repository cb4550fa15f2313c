"""Benchmark of ``distributedkernelshap_tpu_torch`` on an NVIDIA GPU.

``python3 portbench/run.py --workload <config>.<mix> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: it builds the cell's
configuration (``configs/<config>.json``, built by ``kinds/<kind>.py``) from
the seed, drives the traffic mix (``traffic/<mix>.json``) through the port
in a closed loop for ``--seconds``, judges what the timed calls returned
against the plain reference (``reference/``), and prints one JSON line.
With ``--trace 1`` the window runs under ``torch.profiler`` and the
per-layer metrics (``metrics/<name>.py``) are read from its records, with
the roofline counts of ``counts/``.

Nothing here imports JAX or the JAX package; the harness reads no file
outside this directory except ``BENCHMARK.json``.
"""
