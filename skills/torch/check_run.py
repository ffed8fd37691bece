"""Summarize a fault-injection run from its profiling JSONL.

Usage: python skills/fault-injection-loop/check_run.py /tmp/loop/prof.jsonl
Prints detection→restart latency per failure and the event timeline.
"""

import json
import sys
from collections import defaultdict


def main(path: str) -> None:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    if not events:
        print("no events")
        return
    t0 = events[0]["mono_ns"]
    print(f"{'t(ms)':>10}  {'cycle':>5}  event")
    for e in events:
        print(f"{(e['mono_ns'] - t0) / 1e6:10.1f}  {e.get('cycle', '?'):>5}  {e['event']}")

    # latency: failure/hang detected -> next worker_started
    last_fail = None
    latencies = []
    for e in events:
        if e["event"] in ("failure_detected", "hang_detected"):
            last_fail = e["mono_ns"]
        elif e["event"] == "worker_started" and last_fail is not None:
            latencies.append((e["mono_ns"] - last_fail) / 1e6)
            last_fail = None
    if latencies:
        print(f"\nfailure -> workers restarted: {[f'{v:.0f}ms' for v in latencies]}")
    counts = defaultdict(int)
    for e in events:
        counts[e["event"]] += 1
    print("event counts:", dict(counts))


if __name__ == "__main__":
    main(sys.argv[1])
