"""The model families of the benchmark, one module each (`perfbench.bench.family`)."""
