"""The benchmark of the PyTorch and CUDA port, ``pilosa_tpu_torch``.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json; PERF.md describes the
cells, the metrics and the layers.  Nothing here imports JAX or the
JAX package."""
