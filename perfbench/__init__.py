"""The serving benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell is made of
(its model configuration, traffic mix, per-layer metrics, output limits and
plain reference) is a file here, found by name. See ``README.md``."""
