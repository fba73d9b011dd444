"""The benchmark of the PyTorch and CUDA port (`openbts_ttsou_tpu_torch`).

`python -m trxbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on one card. Everything
that decides a cell's numbers lives here: the traffic generator, the
plain reference, the comparison and its limits, the peaks and the work
counts, and one reader a metric. It imports nothing of the JAX package.
"""
