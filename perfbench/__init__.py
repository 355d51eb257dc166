"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
run once by ``perfbench/run.py``; see BENCHMARK.json at the root."""
