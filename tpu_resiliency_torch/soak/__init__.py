"""The port's chaos soak: the whole resiliency stack under randomized faults.

The port of the JAX package's ``benchmarks/soak_launcher.py`` (its
regression gate), kept in the package as ``dryrun.py`` keeps the port of
``__graft_entry__.py``:

- ``schedule.py`` — the seeded fault schedule and the rings'
  detect->recover latencies (pure);
- ``report.py`` — the verdict, a pure function of what a run left;
- ``launcher.py`` — ``main``, :class:`~.launcher.StoreChaos` and the
  adaptive-vs-fixed A/B;
- ``workloads/`` — the six worker programs, one per campaign family, run
  by the port's launcher by file path;
- ``worker.py`` and ``ramp.py`` — what the workloads share.

    python -m tpu_resiliency_torch.soak --gate

Importing this package imports neither torch nor anything of JAX.
"""
