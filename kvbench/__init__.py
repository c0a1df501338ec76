"""kvbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 kvbench/run.py --workload glm4-9b.docqa-hot --seed 7 --seconds 30 --trace 0

A cell ``<config>.<traffic>`` resolves by name to ``kvbench/configs/<config>.json``
and ``kvbench/traffic/<traffic>.json``; the configuration's optional
``"arch"`` key names its architecture module (``kvbench/arch/<arch>.py``,
``dense_gqa`` without it: weights, reference, stored layout, operations
and bytes, kernels); the traffic file names the runner
(``kvbench/runners/<runner>.py``) and the generator; each per-layer metric
is a reader ``kvbench/metrics/<metric>.py``; each cell's correctness
limits are ``kvbench/limits/<cell>.json``.  Nothing here imports ``jax`` or
the JAX package.
"""
