"""ecbench: the benchmark of ceph_tpu_torch's erasure-code path on the card.

    python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; each is a file of its own
under this folder, found by its name (see README.md).
"""
