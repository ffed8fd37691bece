"""Asynchronous checkpointing core (counterpart of
``tpu_resiliency/checkpointing/async_ckpt``)."""
