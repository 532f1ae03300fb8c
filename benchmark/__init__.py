"""The benchmark of the PyTorch and CUDA port (`metamorph_tpu_torch`).

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root names the cells; each configuration, traffic
mix, driver, per-layer metric, roofline count and limit set is a file of
its own here, found by the name the JSON gives it.
"""
