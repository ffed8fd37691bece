"""Device-side operations of the port: the quorum hang-detection lane and
its hand-written CUDA kernel (``csrc/``)."""
