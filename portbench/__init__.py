"""The benchmark of the PyTorch and CUDA port (``hl_hgat_tpu_torch``) on one
H100: ``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, cells in ``BENCHMARK.json``.  Nothing here imports JAX or
the JAX package; ``reference/`` imports nothing of the port either."""
