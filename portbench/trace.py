"""The device trace of a run's window, and what is read from it.

``torch.profiler``'s CUDA activity (CUPTI) records every operation that ran
on the card, the port's ctypes-launched kernels included.  A window holds
millions of them, so the trace is taken through the profiler's low-level
entry points and reduced here in one pass, without building the profiler's
per-event Python objects.  Its timestamps are nanoseconds of the host's
wall clock (``time.time_ns``), the clock the harness stamps its own spans
with, so an idle gap on the card can be named by what the host was doing.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, int, int]  # (name, start ns, end ns) on time.time_ns
_FAMILIES = (
    ("kernel1", ("local_max_",)),
    ("nccl", ("nccl",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("softmax", ("softmax",)),
    ("transfer", ("memcpy", "memset")),
    ("copy_cast", ("copy", "convert")),
    ("elementwise", ("elementwise", "reduce", "where")),
)


class Trace:
    """Reduced device trace of ``[t0_ns, t1_ns]``: per-name kernel time and
    count, the union of device intervals, and the idle gaps between them."""

    def __init__(self, t0_ns: int, t1_ns: int, ops: Dict[str, List[int]],
                 intervals: List[Tuple[int, int]]):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.ops = ops            # name -> [count, total ns]
        self.window_s = (t1_ns - t0_ns) / 1e9
        busy, gaps, cursor = 0, [], t0_ns
        for s, e in intervals:
            s, e = max(s, t0_ns), min(e, t1_ns)
            if e <= s:
                continue
            if s > cursor:
                gaps.append((cursor, s))
            busy += e - max(s, cursor) if e > cursor else 0
            cursor = max(cursor, e)
        if t1_ns > cursor:
            gaps.append((cursor, t1_ns))
        self.busy_s = busy / 1e9
        self.gaps = gaps

    def idle_share(self) -> Optional[float]:
        """Percent of the window in which nothing ran on the card."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def matching(self, fragment: str) -> Tuple[int, int]:
        """(launches, total ns) of the operations whose name holds
        ``fragment``."""
        n = t = 0
        for name, (count, total) in self.ops.items():
            if fragment in name:
                n += count
                t += total
        return n, t

    def families(self) -> Dict[str, float]:
        """Seconds of device time by kind of operation, read from the
        kernel names: matrix products, softmax, copies and casts, other
        elementwise, memory transfers, kernel 1, NCCL."""
        out: Dict[str, float] = defaultdict(float)
        for name, (_, total) in self.ops.items():
            low = name.lower()
            kind = next((k for k, keys in _FAMILIES if any(x in low for x in keys)),
                        "other")
            out[kind] += total / 1e9
        return dict(out)

    def top_ops(self, k: int = 10) -> List[list]:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:160], total / 1e9] for name, (_, total) in top]

    def top_gaps(self, spans: List[Span], k: int = 10) -> List[list]:
        """The ``k`` longest idle gaps, each named by the innermost host span
        around its middle (``idle`` where the harness had none open)."""
        out = []
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + e) // 2
            around = [sp for sp in spans if sp[1] <= mid <= sp[2]]
            name = min(around, key=lambda sp: sp[2] - sp[1])[0] if around else "idle"
            out.append([name, (e - s) / 1e9])
        return out


class Recorder:
    """Start and stop the CUDA activity trace around a window."""

    def __init__(self):
        import torch
        from torch.autograd import ProfilerActivity, _prepare_profiler

        self._torch = torch
        self._acts = {ProfilerActivity.CUDA}
        self._config = torch.autograd.profiler.profile(use_device="cuda").config()
        _prepare_profiler(self._config, self._acts)  # CUPTI's start-up, in set-up
        self.t0_ns: Optional[int] = None

    def start(self) -> None:
        from torch.autograd import _enable_profiler

        _enable_profiler(self._config, self._acts)
        self.t0_ns = time.time_ns()

    def stop(self) -> Trace:
        from torch.autograd import DeviceType, _disable_profiler

        self._torch.cuda.synchronize()
        t1_ns = time.time_ns()
        events = _disable_profiler().events()
        cuda = DeviceType.CUDA
        ops: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        intervals = []
        for ev in events:
            if ev.device_type() != cuda:
                continue
            start, dur = ev.start_ns(), ev.duration_ns()
            intervals.append((start, start + dur))
            rec = ops[ev.name()]
            rec[0] += 1
            rec[1] += dur
        intervals.sort()
        return Trace(self.t0_ns, t1_ns, dict(ops), intervals)
