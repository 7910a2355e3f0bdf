"""The benchmark of the PyTorch port (``recommendation_models_tpu_torch``).

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. A cell (``workloads`` in ``BENCHMARK.json``)
names a configuration and a traffic mix; the harness finds

- the configuration's sizes in ``benchmark/configs/<config>.json``,
- the traffic mix's parameters in ``benchmark/traffic/<traffic>.json``, whose
  ``runner`` names the module of ``benchmark/runners/`` that runs it,
- the cell's limits of ``correct`` in ``benchmark/workloads/<name>.json``,
- each metric's reader in ``benchmark/metrics/<metric>.py``,
- the configuration's plain reference in ``benchmark/references/``.

The yardstick lives here and nowhere in the port: the generator of the
ratings (``datagen``), the needed work and the peaks (``work``), the
reduction of the profiler's trace (``trace``) and the comparison that
decides ``correct`` (``check``). None of it imports JAX or the JAX package,
and the references import nothing of the port.
"""
