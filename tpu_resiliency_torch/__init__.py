"""tpu_resiliency_torch — the PyTorch/CUDA port of ``tpu_resiliency``.

It imports ``torch`` and numpy and nothing of JAX or of the JAX package.
Module paths and public names mirror the JAX package (``ops/quorum.py``,
``models/transformer.py``, ``parallel/…``), so each counterpart is easy to
find.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
