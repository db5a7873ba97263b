"""The benchmark of the PyTorch and CUDA port (``pointcloudmatters_tpu_torch``):
``run.py`` runs one cell; ``BENCHMARK.json`` at the checkout's root names them."""
