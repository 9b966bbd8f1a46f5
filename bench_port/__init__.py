"""The benchmark of grakel_torch on NVIDIA H100 cards.

One command runs one cell once::

    python -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in ``BENCHMARK.json`` at
the root of the checkout; each configuration, traffic mix and per-layer
metric is a file of its own here, found by that name (:mod:`.manifest`).
Nothing here imports JAX or the JAX package, and the references
(:mod:`.refcommon`, :mod:`.svm_ref`, ``configs/*.py``) import nothing of
grakel_torch.
"""
