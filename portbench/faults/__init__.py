"""Fault classes, one module each, found by the name a traffic file gives.

``portbench/faults/<class>.py`` holds ``fire(cw, step)``, called from the
step loop when a fault of that class is due: it breaks the run the way the
class says and never returns.  A fault class is added by adding its module.
"""

from __future__ import annotations

import importlib


class InjectedFault(RuntimeError):
    """An exception a fault class raises on purpose."""


def fire(name: str, cw, step: int) -> None:
    """Inject a fault of class ``name`` into the ring's call ``cw``."""
    importlib.import_module(f"{__name__}.{name}").fire(cw, step)
    raise RuntimeError(f"fault class {name!r} returned instead of breaking the run")
