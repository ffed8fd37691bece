"""The chaos soak's verdict: one pure function from what a run left to the
report it prints.

The port of ``benchmarks/soak_launcher.py``'s report (its lines after the
run ends), factored out of ``main`` so the same inputs can be fed to both
packages: the launcher's stdout chunks, the profiling events, the progress
samples and the parsed arguments, plus three facts the reference reads off
its live objects (the launcher's pid, the store kills, the ``*.corrupt``
files left at exit).  The verdict terms are the reference's: ``monotone``,
``bounds_ok``, ``rings_ok``, ``ladder_ok``, ``saves_ok`` and each
campaign's own check.  The port adds what its workers counted
(``worker_counts``): kernel 1's launches summed over every worker process
(``kernel1_launches``) and the devices they ran on (``worker_devices``).
"""

from __future__ import annotations

import re

from .schedule import _ring_latencies

# the long-poll campaign's store poll quantum (TPURX_STORE_POLL_S)
LP_POLL_S = 0.25


def _med(xs):
    return round(sorted(xs)[len(xs) // 2], 1) if xs else None


def build_report(chunks, events, progress_samples, args, *, launcher_pid,
                 store_kills=0, end_debris=0, worker_counts=()) -> dict:
    """The report dict; ``report["ok"]`` is the gate's verdict."""
    out = "".join(chunks)
    events = sorted(events, key=lambda e: e.get("mono_ns", 0))
    outer_ms, inner_ms = _ring_latencies(events)
    # restart cycles = launcher-recorded worker (re)starts beyond the first
    # (the launcher records worker_started in ITS pid; wrapper copies are
    # worker pids)
    cycles = max(0, sum(
        1 for ev in events
        if ev.get("event") == "worker_started" and ev.get("pid") == launcher_pid
    ) - 1)
    injected = {
        "crashes": out.count("] crash at step"),
        "hangs": out.count("] hang at step"),
        "exceptions": out.count("] exception at step"),
        "quorum_stalls": out.count("] quorum stall at step"),
        "collective_wedges": out.count("] collective wedge at step"),
    }
    monotone = all(b >= a for a, b in zip(progress_samples, progress_samples[1:]))
    final = progress_samples[-1] if progress_samples else 0
    bounds_ok = True
    if inner_ms and not (_med(inner_ms) <= args.inner_bound_ms):
        bounds_ok = False
    if outer_ms and not (_med(outer_ms) <= args.outer_bound_ms):
        bounds_ok = False
    inner_faults = (injected["exceptions"] + injected["quorum_stalls"]
                    + injected["collective_wedges"])
    # faults were injected -> the matching ring must actually have run
    rings_ok = (
        (inner_faults == 0 or inner_ms)
        and (injected["crashes"] + injected["hangs"] == 0 or cycles >= 1)
    )
    # abort-ladder stage outcomes from the profiling stream: every inner
    # trip runs the ladder, whose fingerprint rung must have released
    stage_outcomes: dict = {}
    for ev in events:
        if ev.get("event") == "abort_stage":
            key = f"{ev.get('stage')}/{ev.get('outcome')}"
            stage_outcomes[key] = stage_outcomes.get(key, 0) + 1
    ladder_ok = (
        inner_faults == 0 or not inner_ms
        or stage_outcomes.get("fingerprint/released", 0) >= 1
    )
    # store-outage-mid-save: every save that started must have completed
    # (the unified retry policy rides out the kill); tolerated shortfalls:
    # one save aborted per worker restart (either ring) plus the single
    # save the soak's own deadline may cut off in flight
    saves_started = out.count("] save start at step")
    saves_done = out.count("] save done at step")
    saves_ok = True
    if args.store_kill_mid_save:
        tolerance = cycles + len(inner_ms) + 1
        saves_ok = (
            saves_started >= 1
            and saves_done >= max(1, saves_started - tolerance)
        )
    # warm-restore campaign (--peer-mem-kill): every non-serving rank's
    # drill must have been served from its OWN DISK (peer rung timed out
    # against the stalled server) at fallback depth 0 — the stall degrades
    # the restore to a colder source, never to an older iteration
    peer_report: dict = {}
    peer_ok = True
    if args.peer_mem_kill:
        drills = [
            tuple(int(x) for x in m)
            for m in re.findall(
                r"soaklc\[(\d+)\] peer-drill it=(\d+) disk_b=(\d+) "
                r"peer_b=(\d+) depth=(\d+)", out)
        ]
        nonserving = [d for d in drills if d[0] != 0]
        peer_ok = bool(
            drills
            and {d[0] for d in drills} == set(range(args.nproc))
            and nonserving
            and all(disk > 0 and peer == 0 and depth == 0
                    for _r, _it, disk, peer, depth in nonserving)
        )
        peer_report = {
            "peer_mem_kill": True,
            "peer_drills": drills,
            "peer_ok": peer_ok,
        }
        if not args.corrupt_blob:
            # lckpt workloads track progress through checkpoint iterations
            monotone = True
            final = max((d[1] for d in drills), default=0)
    # self-healing-collectives campaign (--link-degrade): every rank must
    # FINISH (no restart of any kind), the armed rank must have walked the
    # degrade ladder (timeouts then degrades both nonzero), the healthy
    # ranks must have degraded nothing, and the launcher ring must have
    # recorded ZERO restart cycles
    coll_report: dict = {}
    coll_ok = True
    if args.link_degrade:
        marks = [
            tuple(int(x) for x in m)
            for m in re.findall(
                r"soakcoll\[(\d+)\] result=done degrades=(\d+) "
                r"timeouts=(\d+)", out)
        ]
        armed = [m for m in marks if m[0] == 0]
        coll_ok = bool(
            marks
            and {m[0] for m in marks} == set(range(args.nproc))
            and armed and armed[0][1] >= 1 and armed[0][2] >= 1
            # healthy ranks may eat a first-call latency timeout (the
            # retry rung absorbs it) but must never DEGRADE
            and all(m[1] == 0 for m in marks if m[0] != 0)
            and cycles == 0
        )
        coll_report = {
            "link_degrade": True,
            "coll_marks": marks,
            "coll_degrades": armed[0][1] if armed else 0,
            "coll_timeouts": armed[0][2] if armed else 0,
            "coll_ok": coll_ok,
        }
        monotone = all(
            b >= a for a, b in zip(progress_samples, progress_samples[1:])
        )
        final = len(marks)
    # predict-and-evacuate campaign (--ramp-degrade): the fused rank risk
    # must evacuate the ramping victim BEFORE its hard-fault deadline and
    # never touch a healthy rank, and the victim's slot must warm-join
    # chunk-granular off peer memory (zero disk bytes, no global restore)
    evac_report: dict = {}
    evac_ok = True
    if args.ramp_degrade:
        evacs = [
            (int(r), int(s))
            for r, s in re.findall(
                r"soakev\[0\] EVACUATE rank=(\d+) at step=(\d+)", out)
        ]
        joins = [
            (r, int(it), int(pb), int(db))
            for r, it, pb, db in re.findall(
                r"soakev\[\d+\] JOIN warm=(\w+) iter=(\d+) peer_b=(\d+) "
                r"disk_b=(\d+)", out)
        ]
        hard_faults = out.count("] HARD FAULT at step")
        done = len(re.findall(r"soakev\[\d+\] result=done joined=True", out))
        victim_rank = 1
        evac_ok = bool(
            evacs
            and {r for r, _s in evacs} == {victim_rank}  # nobody healthy
            and hard_faults == 0                # fired before the deadline
            and joins
            and all(w == "True" and pb > 0 and db == 0
                    for w, _it, pb, db in joins)
            and done == args.nproc
        )
        evac_report = {
            "ramp_degrade": True,
            "evacuations": evacs,
            "evac_joins": joins,
            "hard_faults": hard_faults,
            "evac_ok": evac_ok,
        }
        monotone = True
        final = done
    # interruptible-long-poll campaign (--store-longpoll-abort): every
    # injection must LAND on the parked rank within the abort-propagation
    # budget plus 2x the poll quantum, and no rank may ever exit ret=None
    lp_report: dict = {}
    lp_ok = True
    if args.store_longpoll_abort:
        def _marks(kind):
            return {
                int(ep): float(t)
                for ep, t in re.findall(
                    rf"soaklp\[\d+\] {kind} ep=(\d+) t=([0-9.]+)", out)
            }

        injects, landings = _marks("inject"), _marks("landed")
        land_ms = sorted(
            (landings[ep] - injects[ep]) * 1000.0
            for ep in landings if ep in injects
        )
        # budget: the injector's raise propagates through its wrapper's
        # abort broadcast and the victim's monitor thread before the async
        # raise is even issued; only then does the poll-quantum contract
        # (2x TPURX_STORE_POLL_S) apply to the landing itself
        bound_s = (args.longpoll_bound_s if args.longpoll_bound_s is not None
                   else 4.0 + 2 * LP_POLL_S)
        # the last episode may be cut off mid-park by the soak deadline
        complete = [ep for ep in injects if ep in landings]
        lp_ok = bool(
            len(injects) >= 1
            and len(complete) >= max(1, len(injects) - 1)
            and land_ms
            and max(land_ms) <= bound_s * 1000.0
            and "ret=None" not in out
            and "result=None" not in out
        )
        lp_report = {
            "store_longpoll_abort": True,
            "lp_episodes_injected": len(injects),
            "lp_episodes_landed": len(landings),
            "lp_land_ms": [round(x, 1) for x in land_ms],
            "lp_land_ms_median": (round(land_ms[len(land_ms) // 2], 1)
                                  if land_ms else None),
            "lp_bound_ms": bound_s * 1000.0,
            "lp_ret_none": out.count("ret=None") + out.count("result=None"),
            "lp_ok": lp_ok,
        }
        monotone = True  # no progress file in this campaign
        final = len(landings)
    # checkpoint-integrity campaign (--corrupt-blob): the corrupt blobs must
    # be detected + quarantined and EVERY rank must fallback-restore an
    # iteration strictly older than the corrupted one
    ckpt_report: dict = {}
    ckpt_ok = True
    if args.corrupt_blob:
        corrupted = re.findall(
            r"soaklc\[\d+\] corrupted newest mode=\S+ files=(\d+) "
            r"iters=iter_(\d+)", out)
        restores = [
            tuple(int(x) for x in m)
            for m in re.findall(
                r"soaklc\[(\d+)\] restored iter=(\d+) depth=(\d+) "
                r"corrupt=(\d+) quarantined=(\d+) debris=(\d+)", out)
        ]
        corrupted_iter = int(corrupted[0][1]) if corrupted else None
        fb = [r for r in restores if r[2] >= 1]
        ckpt_ok = bool(
            corrupted and int(corrupted[0][0]) >= 1
            and fb
            and {r[0] for r in fb} == set(range(args.nproc))
            and all(it < corrupted_iter for _r, it, _d, _c, _q, _f in fb)
            and all(c >= 1 and q >= 1 and f >= 1
                    for _r, _it, _d, c, q, f in fb)
        )
        ckpt_report = {
            "corrupt_blob": args.corrupt_blob,
            "corrupted_iter": corrupted_iter,
            "restores": restores,
            "fallback_restores": fb,
            # end-of-run debris is best-effort (keep_last pruning reclaims
            # quarantined iter dirs); the restore-time count is authoritative
            "quarantine_debris_at_exit": end_debris,
            "ckpt_ok": ckpt_ok,
        }
        # the lckpt workload tracks progress through checkpoint iterations,
        # not the progress file — those checks don't apply
        monotone = True
        final = max((r[1] for r in restores), default=0)
    if args.store_longpoll_abort:
        ok = bool(lp_ok)
    elif args.ramp_degrade:
        ok = bool(evac_ok)
    elif args.corrupt_blob:
        ok = bool(ckpt_ok and peer_ok and cycles >= 1)
    elif args.link_degrade:
        ok = bool(coll_ok and monotone)
    elif args.peer_mem_kill:
        ok = bool(peer_ok and final > 0)
    else:
        ok = bool(monotone and final > 0 and bounds_ok and rings_ok
                  and ladder_ok and saves_ok)
    return {
        "metric": "soak_launcher",
        "seconds": args.seconds,
        "chaos_store": args.chaos_store,
        "store_kills": store_kills,
        "quorum": args.quorum,
        "final_progress": final,
        "progress_samples": progress_samples[-12:],
        "cycles": cycles,
        "injected": injected,
        "inner_ring_recoveries": len(inner_ms),
        "inner_detect_to_recover_ms_median": _med(inner_ms),
        "outer_ring_recoveries": len(outer_ms),
        "outer_detect_to_recover_ms_median": _med(outer_ms),
        "abort_stage_outcomes": stage_outcomes,
        "saves_started": saves_started,
        "saves_done": saves_done,
        "monotone_progress": monotone,
        "bounds_ok": bounds_ok,
        "ladder_ok": ladder_ok,
        "saves_ok": saves_ok,
        **coll_report,
        **peer_report,
        **evac_report,
        **lp_report,
        **ckpt_report,
        "workers": len(worker_counts),
        "worker_devices": sorted({c.get("device", "?") for c in worker_counts}),
        "kernel1_launches": sum(int(c.get("quorum_local_max", 0))
                                for c in worker_counts),
        "ok": ok,
    }
