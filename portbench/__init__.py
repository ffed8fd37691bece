"""The benchmark of the PyTorch port (``tpu_resiliency_torch``).

One run is one cell of ``BENCHMARK.json`` (a model configuration under a
traffic mix) on the machine it is started on:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``.
The yardstick lives here too: the traffic generator (``feed.py``,
``schedule.py``), the weights made from the seed (``weights.py``), the
operation and byte counts and the card's peaks (``counts.py``), the trace
reduction (``trace.py``), the plain float32 reference
(``reference/decoder.py``) and the comparison that decides ``correct``
(``check.py``).  Nothing here imports JAX or the JAX package.
"""
