"""The benchmark of ``columbiaimagesearch_tpu_torch`` on NVIDIA cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Each configuration, traffic mix, traffic kind, per-layer metric and
cell's limits is a file of its own (``configs/``, ``traffic/``,
``kinds/``, ``metrics/``, ``limits/``), found by name (``spec.py``). The plain reference is in ``reference/``;
the yardstick of the shares in ``roofline.py``. Nothing here imports JAX
or the JAX package.
"""
