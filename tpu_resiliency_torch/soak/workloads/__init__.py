"""The chaos soak's worker programs, one per workload of the JAX package's
``benchmarks/soak_launcher.py``.  The soak's launcher runs each by its file
path; importing one runs nothing."""
