"""Benchmark of the PyTorch and CUDA port (``hichap_master_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; the modules here are
the yardstick that later changes to the port are measured with: the
seeded pair generator (``generator``), the plain reference and the
comparison that decides ``correct`` (``reference``, ``compare``), the
jobs the window drives (``jobs``), the reduction of a profiler trace
(``trace``) and the card's peaks (``peaks``).  Nothing here imports
``jax`` or the JAX package.
"""
