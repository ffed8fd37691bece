"""Checkpoint dtype names, resolved without ``ml_dtypes``.

``metadata.json`` names each leaf's dtype as the JAX package writes it
(``str`` of the numpy dtype): ``"bfloat16"``, ``"float32"``, ``"bool"``, ...
The JAX package resolves ``"bfloat16"`` through ``ml_dtypes``; the port
has no such package and needs none:

- The host side of a checkpoint (the writer process, the restore engine)
  holds a leaf's bytes in a numpy array of a *storage* dtype of the same
  width (:func:`resolve_dtype`).  That is the dtype itself, except for
  ``bfloat16``, whose bit patterns sit in ``uint16``: bf16 never passes
  through numpy as a value.  This half imports no torch (the writer
  process imports it).
- The tensor side (:func:`torch_dtype`, :func:`dtype_name`,
  :func:`to_tensor`) moves the raw bytes through ``uint8`` views, so a
  restored tensor holds exactly the bytes on disk.  It imports torch when
  called.
"""

from __future__ import annotations

import numpy as np

# metadata dtype name -> numpy storage dtype of the same itemsize
_STORAGE = {
    "bfloat16": np.uint16,
    "float16": np.float16,
    "float32": np.float32,
    "float64": np.float64,
    "int8": np.int8,
    "uint8": np.uint8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "bool": np.bool_,
    "complex64": np.complex64,
    "complex128": np.complex128,
}
NAMES = tuple(_STORAGE)


def resolve_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds the bytes of checkpoint dtype ``name``:
    one of :data:`NAMES`, or any other name numpy knows (a host leaf may
    be any numpy array)."""
    storage = _STORAGE.get(name)
    if storage is not None:
        return np.dtype(storage)
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(f"checkpoint dtype {name!r} is not one the port reads "
                        f"({', '.join(NAMES)}, or a numpy dtype)") from None


def from_bytes(raw, dtype_name: str, shape) -> np.ndarray:
    return (
        np.frombuffer(raw, dtype=resolve_dtype(dtype_name))
        .reshape(shape)
        .copy()
    )


def torch_dtype(name: str):
    """The torch dtype of checkpoint dtype ``name``."""
    import torch

    if name not in _STORAGE:
        raise TypeError(f"checkpoint dtype {name!r} has no tensor dtype in the "
                        f"port ({', '.join(NAMES)})")
    return getattr(torch, name)


def dtype_name(dtype) -> str:
    """The checkpoint name of a torch dtype (the name the JAX writer writes
    for the same numpy dtype)."""
    name = str(dtype).removeprefix("torch.")
    if name not in _STORAGE:
        raise TypeError(f"tensor dtype {dtype} has no checkpoint name in the "
                        f"port ({', '.join(NAMES)})")
    return name


def to_tensor(arr: np.ndarray, name: str):
    """A CPU tensor of checkpoint dtype ``name`` over the bytes of ``arr``
    (a storage-dtype array from :func:`resolve_dtype`), without a copy."""
    import torch

    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return torch.from_numpy(flat).view(torch_dtype(name)).reshape(arr.shape)
