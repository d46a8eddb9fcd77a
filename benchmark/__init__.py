"""The benchmark of ``lcp_physics_tpu_torch`` on one NVIDIA card.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything is found by the names ``BENCHMARK.json`` and the
files give (``harness/spec.py``): configurations (``configs/``), traffic
mixes (``traffic/``), per-cell limits (``limits/``), the loops a mix
names (``loops/``), the scene kinds (``scenes/``), the body shapes of a
configuration (``shapes/``, and ``reference/shapes/`` for the reference)
and per-layer metric readers (``metrics/``); ``reference/`` is the plain
reference that decides ``correct``.
"""
