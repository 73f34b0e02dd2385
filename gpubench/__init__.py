"""The benchmark of ``dusty_gan_torch`` on NVIDIA GPUs: ``python3 -m
gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Cells, configurations, traffic and per-layer metrics are data named in
``BENCHMARK.json`` (``harness.py``); the plain references that decide
``correct`` are in ``reference/``.  Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of ``dusty_gan_torch``.
"""
