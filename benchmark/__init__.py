"""The benchmark of vqatpu_torch on the H100: run one cell with
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (see ``run.py``).  It never
imports JAX or the JAX package."""
