"""Typed registry of the ``TPURX_*`` environment knobs the port reads.

The port's copy of ``tpu_resiliency/utils/env.py``, cut to the knobs this
package reads.  Names, types, defaults and doc lines are the same as in the
JAX package, so one environment drives both packages.

Parse conventions (uniform for every knob):

- empty string == unset (falls back to the declared default);
- bool: ``0 / false / no / off`` (case-insensitive) are False, anything else
  set is True;
- a knob may name a ``fallback`` env var (``TPURX_RANK`` falls back to
  plain ``RANK``) consulted when the primary is unset;
- ``Knob.get(default=...)`` overrides the declared default for call sites
  whose default is computed.

This module must import nothing from the package (everything imports it).
"""

from __future__ import annotations

import os

_UNSET = object()
_BOOL_FALSE = frozenset({"0", "false", "no", "off"})

_REGISTRY: dict = {}


class Knob:
    """One declared environment knob."""

    __slots__ = ("name", "type", "default", "doc", "fallback", "group")

    def __init__(self, name: str, type: type, default, doc: str,
                 fallback: str | None = None, group: str = "general"):
        if name in _REGISTRY:
            raise ValueError(f"knob {name} declared twice")
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc
        self.fallback = fallback
        self.group = group
        _REGISTRY[name] = self

    def raw(self) -> str | None:
        """The raw string value from the env, then the fallback var; None
        when unset (empty string counts as unset)."""
        val = os.environ.get(self.name)
        if (val is None or val == "") and self.fallback:
            val = os.environ.get(self.fallback)
        if val == "":
            val = None
        return val

    def is_set(self) -> bool:
        return self.raw() is not None

    def get(self, default=_UNSET):
        """Parsed value, or the (declared or overridden) default when unset.

        Raises ValueError naming the knob on an unparseable value — a typo'd
        knob must fail loudly at read time, not act as silently-default.
        """
        raw = self.raw()
        if raw is None:
            return self.default if default is _UNSET else default
        try:
            return self._parse(raw)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{self.name}={raw!r} is not a valid {self.type.__name__}: {e}"
            ) from e

    def _parse(self, raw: str):
        if self.type is bool:
            return raw.strip().lower() not in _BOOL_FALSE
        if self.type is int:
            return int(raw, 0)
        if self.type is float:
            return float(raw)
        return raw

    def __repr__(self):
        return f"Knob({self.name}, {self.type.__name__}, default={self.default!r})"


def all_knobs():
    """Every declared Knob, sorted by name."""
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def lookup(name: str):
    return _REGISTRY.get(name)


# -- job identity (set by the launcher, read everywhere) --------------------
RANK = Knob(
    "TPURX_RANK", int, 0, "Global rank of this worker.",
    fallback="RANK", group="identity")
LOCAL_RANK = Knob(
    "TPURX_LOCAL_RANK", int, 0, "Rank local to this host.",
    fallback="LOCAL_RANK", group="identity")
WORLD_SIZE = Knob(
    "TPURX_WORLD_SIZE", int, 1, "Total ranks in the job.",
    fallback="WORLD_SIZE", group="identity")
GROUP_RANK = Knob(
    "TPURX_GROUP_RANK", int, 0,
    "Node index within the job (one per agent/host).", group="identity")
NNODES = Knob(
    "TPURX_NNODES", int, 1, "Number of nodes (agents) in the job.",
    group="identity")
INFRA_RANK = Knob(
    "TPURX_INFRA_RANK", int, None,
    "Infrastructure-assigned rank used for log prefixes before the "
    "launcher assigns TPURX_RANK.", group="identity")
CYCLE = Knob(
    "TPURX_CYCLE", int, 0,
    "Restart-cycle counter, bumped by the launcher on every restart; "
    "namespaces store keys and checkpoint rounds.", group="identity")

# -- control-plane store ----------------------------------------------------
STORE_ADDR = Knob(
    "TPURX_STORE_ADDR", str, "127.0.0.1",
    "Host of the control-plane store (seed shard when sharded).",
    group="store")
STORE_PORT = Knob(
    "TPURX_STORE_PORT", int, 29500,
    "Port of the control-plane store seed.", group="store")

# -- telemetry / logging ----------------------------------------------------
TELEMETRY = Knob(
    "TPURX_TELEMETRY", bool, True,
    "Global telemetry switch; 0 swaps every metric for a shared no-op.",
    group="telemetry")
PROFILING_FILE = Knob(
    "TPURX_PROFILING_FILE", str, None,
    "JSONL profiling-event sink path (%r expanded to rank).",
    group="telemetry")
PROFILING_HISTORY = Knob(
    "TPURX_PROFILING_HISTORY", int, 4096,
    "Bounded in-memory profiling event history per process.",
    group="telemetry")
LOG_LEVEL = Knob(
    "TPURX_LOG_LEVEL", str, "INFO", "Root log level for tpurx loggers.",
    group="telemetry")
LOG_FILE = Knob(
    "TPURX_LOG_FILE", str, None,
    "Log file path template (%r expanded to rank, deferred to first "
    "record).", group="telemetry")
FLIGHT = Knob(
    "TPURX_FLIGHT", bool, True,
    "Fault-episode flight recorder; 0 swaps the ring append for a shared "
    "no-op (same discipline as TPURX_TELEMETRY).", group="telemetry")
FLIGHT_RING = Knob(
    "TPURX_FLIGHT_RING", int, 4096,
    "Flight-recorder ring capacity in events (rounded up to a power of "
    "two; oldest events overwritten).", group="telemetry")
FLIGHT_DIR = Knob(
    "TPURX_FLIGHT_DIR", str, None,
    "Directory for flight-recorder black-box dumps (default: the "
    "system temp dir).", group="telemetry")
FLIGHT_DUMP_KEEP = Knob(
    "TPURX_FLIGHT_DUMP_KEEP", int, 32,
    "Dump files retained per process; older dumps this process wrote "
    "are unlinked.", group="telemetry")
CLOCK_TEST_SKEW_NS = Knob(
    "TPURX_CLOCK_TEST_SKEW_NS", int, 0,
    "TEST-ONLY: artificial offset added to this process's monotonic "
    "clock so alignment tests can prove offset recovery.",
    group="telemetry")

# -- health / fault injection ----------------------------------------------
FAULT = Knob(
    "TPURX_FAULT", str, None,
    "Soak-harness fault spec to inject in this worker (class[:arg]).",
    group="health")
FAULT_RANKS = Knob(
    "TPURX_FAULT_RANKS", str, None,
    "Comma-separated ranks the injected fault applies to (default all).",
    group="health")

# -- collectives ------------------------------------------------------------
COLL_DEADLINE_MS = Knob(
    "TPURX_COLL_DEADLINE_MS", float, 30000.0,
    "Default per-op deadline for wrapped resiliency-layer collectives "
    "(ResilientCollective); <=0 disables deadlining (inline fast path).",
    group="collectives")
COLL_RETRIES = Knob(
    "TPURX_COLL_RETRIES", int, 2,
    "Bounded retry budget of the collective degrade ladder's first rung "
    "(re-attempts of the primary lane after a CollectiveTimeout).",
    group="collectives")
COLL_DEGRADE = Knob(
    "TPURX_COLL_DEGRADE", str, "retry,relayout,shrink",
    "Ordered degrade-ladder composition for wrapped collectives: "
    "comma-separated rungs from {retry, relayout, shrink} (empty string "
    "= fail fast on the first CollectiveTimeout).", group="collectives")

# -- checkpointing ----------------------------------------------------------
CKPT_CHUNK_BYTES = Knob(
    "TPURX_CKPT_CHUNK_BYTES", int, 16 << 20,
    "Chunk size of the multi-threaded checkpoint drain/restore engines.",
    group="checkpoint")
CKPT_RESTORE_THREADS = Knob(
    "TPURX_CKPT_RESTORE_THREADS", int, 0,
    "Restore read-engine thread count (0 = same sizing as the write "
    "engine).", group="checkpoint")
CKPT_DIGEST = Knob(
    "TPURX_CKPT_DIGEST", bool, True,
    "Compute per-chunk crc32 spans + composed shard digests during the "
    "drain.", group="checkpoint")
CKPT_DIRECT_IO = Knob(
    "TPURX_CKPT_DIRECT_IO", bool, True,
    "Use O_DIRECT for checkpoint reads/writes (buffered fallback on "
    "EINVAL).", group="checkpoint")
CKPT_STAGER_NICE = Knob(
    "TPURX_CKPT_STAGER_NICE", int, 10,
    "nice() increment applied to the async-save stager thread.",
    group="checkpoint")
CKPT_WORKER_NICE = Knob(
    "TPURX_CKPT_WORKER_NICE", int, 10,
    "nice() increment applied to the checkpoint writer process.",
    group="checkpoint")
CKPT_WORKER_IONICE = Knob(
    "TPURX_CKPT_WORKER_IONICE", int, 3,
    "ionice class for the checkpoint writer process (3 = idle).",
    group="checkpoint")
CKPT_RESIDENT = Knob(
    "TPURX_CKPT_RESIDENT", bool, True,
    "Keep the last committed checkpoint generation memory-resident (the "
    "staging shm pool / replica blobs) as the warm restore source.",
    group="checkpoint")
CKPT_DELTA = Knob(
    "TPURX_CKPT_DELTA", bool, False,
    "Delta saves: skip draining chunks whose crc32 matches the previous "
    "committed index (requires digests; per-save delta= overrides; the "
    "index records per-chunk provenance so restores cover every byte).",
    group="checkpoint")
CKPT_DEVICE_DIGEST = Knob(
    "TPURX_CKPT_DEVICE_DIGEST", bool, False,
    "Compute per-chunk change fingerprints on-device before staging: delta "
    "saves skip the D2H transfer (not just the disk write) for shards whose "
    "fingerprints all match the committed baseline, and every transferred "
    "chunk's device verdict is cross-checked against the host crc32 "
    "(disagreement fails the save as a detected corruption).",
    group="checkpoint")
CKPT_STAGE_BUFFERS = Knob(
    "TPURX_CKPT_STAGE_BUFFERS", int, 2,
    "Device-side snapshot slots of the async-save ring (snapshot stage "
    "mode): with >=2, the next step's snapshot reuses a slot whose staging "
    "already drained (donated buffers) so compute overlaps the previous "
    "slice's D2H; 1 restores the single-copy behavior.",
    group="checkpoint")
CKPT_INTERVAL_S = Knob(
    "TPURX_CKPT_INTERVAL_S", float, None,
    "Target seconds between async checkpoint saves; SaveScheduler reads "
    "it per step, so policy runtime overrides retune cadence mid-run.",
    group="checkpoint")
