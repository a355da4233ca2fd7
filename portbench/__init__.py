"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on an
NVIDIA H100: ``run.py`` is its command, ``BENCHMARK.json`` at the root of
the repository its cells and metrics.  Configurations, traffic mixes,
correctness limits and metric readers are files of their own under
``configs/``, ``traffic/``, ``limits/`` and ``metrics/``, found by name."""
