"""The benchmark of the PyTorch/CUDA port (`circuits_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` (at the checkout's root)
on one card and prints one JSON line; `harness.py` says how. The folder
holds the yardstick, which imports nothing of the JAX package: the traffic
generator (`traffic.py`, reading `traffic/<mix>.json`), the configurations
(`configs/`), the plain reference (`reference/`, a frozen copy of the
port's host builder, importing nothing of the port), the per-layer readers
and the kernel work counts with the card's fixed peak (`metrics/`).
"""
