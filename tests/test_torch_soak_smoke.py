"""CI smoke of the port's chaos soak (``python -m tpu_resiliency_torch.soak``)
on the CPU: each test of the JAX package's ``tests/test_soak_smoke.py``
with its own arguments, ``--device cpu``, and its own assertions.

The port's workers run the port's whole stack (its launcher and rank
monitors, its control plane SIGKILLed mid-run, the in-process ``Wrapper``
ring, the quorum tripwire over a world of one per worker) under the same
randomized fault classes, and the report holds both rings to the
reference's detect->recover bounds read from the shared profiling JSONL.
On the card the same campaigns run in ``chip_smoke.py``'s soak phase.

The reference's ``test_soak_smoke_fault_shift_goodput_ab`` fails in every
tier-1 run of the JAX package's tests: its adaptive arm does not reach the
1.1x goodput gain over 20 s arms on a CPU host.  The port's copy below is
held to the same assertions, and fails when the port's adaptive arm falls
short in the same way.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _soak(*argv) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_resiliency_torch.soak", *argv, "--device", "cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    last = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert last, proc.stdout[-2000:] + proc.stderr[-2000:]
    return json.loads(last[-1])


def test_soak_smoke_chaos_store_and_quorum():
    report = _soak(
        "--seconds", "50", "--chaos-store", "--quorum",
        "--store-kill-every", "18", "28",
        "--exc-p", "0.02", "--qstall-p", "0.012", "--cwedge-p", "0.008",
        # the reference smoke's bounds for a loaded CI host; the gate run
        # uses the defaults
        "--inner-bound-ms", "15000", "--outer-bound-ms", "60000",
    )
    assert report["ok"], report
    assert report["store_kills"] >= 1, report
    assert report["monotone_progress"], report
    # both rings actually exercised
    assert report["inner_ring_recoveries"] >= 1, report
    # the abort ladder ran on inner trips with recorded stage outcomes
    assert report["ladder_ok"], report
    if report["inner_ring_recoveries"]:
        assert report["abort_stage_outcomes"].get(
            "fingerprint/released", 0
        ) >= 1, report
    total_outer_faults = (
        report["injected"]["crashes"] + report["injected"]["hangs"]
    )
    if total_outer_faults:
        assert report["cycles"] >= 1, report
    # every worker ran where it was told to (the card's launches are 0 here)
    assert report["worker_devices"] == ["cpu"], report


def test_soak_smoke_corrupt_blob_fallback_restore():
    """Every copy of the newest local checkpoint is bit-flipped mid-run and
    the gang hard-restarts; the restarted ranks must detect + quarantine
    the corruption and fallback-restore the next-oldest valid iteration on
    all ranks (each restore bit for bit against its iteration's tree)."""
    report = _soak("--seconds", "45", "--corrupt-blob", "bitflip")
    assert report["ok"], report
    assert report["ckpt_ok"], report
    assert report["corrupted_iter"] is not None, report
    assert report["cycles"] >= 1, report
    fb = report["fallback_restores"]
    assert {r[0] for r in fb} == {0, 1}, report
    for _rank, it, depth, corrupt, quarantined, debris in fb:
        assert it < report["corrupted_iter"]
        assert depth >= 1 and corrupt >= 1 and quarantined >= 1 and debris >= 1


def test_soak_smoke_peer_mem_kill_falls_to_disk():
    """At the drill step the serving rank drops every peer-memory chunk
    request, so each other rank must time the rung out and restore from
    its OWN disk blob at fallback depth 0."""
    report = _soak("--seconds", "35", "--peer-mem-kill")
    assert report["ok"], report
    assert report["peer_ok"], report
    drills = report["peer_drills"]
    assert {d[0] for d in drills} == {0, 1}, report
    for rank, _it, disk_b, peer_b, depth in drills:
        if rank != 0:  # rank 0 serves (and restores warm from its resident)
            assert disk_b > 0 and peer_b == 0 and depth == 0, report


def test_soak_smoke_link_degrade_no_restart():
    """Rank 0's primary collective lane stalls past its deadline every
    call; the resilient wrapper must absorb the bad link in process, every
    rank must finish, and the launcher ring must record ZERO restart
    cycles."""
    report = _soak("--seconds", "110", "--link-degrade")
    assert report["ok"], report
    assert report["coll_ok"], report
    assert report["cycles"] == 0, report
    assert report["coll_degrades"] >= 1, report
    assert report["coll_timeouts"] >= 1, report
    marks = {m[0]: m for m in report["coll_marks"]}
    assert marks[1][1] == 0, report


def test_soak_smoke_store_outage_mid_save():
    """Targeted store kills inside rank 0's store-backed save windows; the
    unified retry policy must ride the save through the outage."""
    report = _soak(
        "--seconds", "55", "--store-kill-mid-save",
        "--save-every", "30", "--store-down", "2.0",
        # isolate the fault class: no random worker faults
        "--exc-p", "0", "--crash-p", "0", "--hang-p", "0",
        "--qstall-p", "0", "--cwedge-p", "0",
        "--inner-bound-ms", "15000", "--outer-bound-ms", "60000",
    )
    assert report["ok"], report
    assert report["saves_started"] >= 1, report
    assert report["saves_ok"], report
    assert report["store_kills"] >= 1, report
    assert report["monotone_progress"], report


def test_soak_smoke_ramp_degrade_evacuates_before_hard_fault():
    """The fused per-rank risk must evacuate the ramping rank BEFORE its
    hard-fault deadline, never the healthy rank, and the evacuated slot
    must warm-join from peer memory with zero disk bytes."""
    report = _soak("--seconds", "120", "--ramp-degrade")
    assert report["ok"], report
    assert report["evac_ok"], report
    assert report["hard_faults"] == 0, report
    assert [r for r, _s in report["evacuations"]] == [1], report
    for warm, _it, peer_b, disk_b in report["evac_joins"]:
        assert warm == "True" and peer_b > 0 and disk_b == 0, report


def test_soak_smoke_store_longpoll_abort_lands():
    """Every restart episode parks one rank deep in a server-held store
    wait() and injects a sibling fault; the async abort must LAND on the
    parked rank within the propagation budget + 2x poll quantum and no rank
    may ever exit ret=None."""
    report = _soak(
        "--seconds", "12", "--store-longpoll-abort",
        # the reference smoke's bound for a loaded CI host
        "--longpoll-bound-s", "10.0",
    )
    assert report["ok"], report
    assert report["lp_ok"], report
    assert report["lp_episodes_injected"] >= 1, report
    assert report["lp_episodes_landed"] >= 1, report
    assert report["lp_ret_none"] == 0, report
    assert report["lp_land_ms_median"] is not None, report


def test_fault_schedule_generation_is_deterministic():
    """Same seed -> byte-identical injection timeline; different seed ->
    different draws; the regime shift multiplies fault density after
    shift_at."""
    from tpu_resiliency_torch.soak.schedule import _gen_fault_schedule

    kw = dict(shift_at=1000, shift_mult=6.0)
    a = _gen_fault_schedule(7, 2, 4000, {"exception": 0.004}, **kw)
    b = _gen_fault_schedule(7, 2, 4000, {"exception": 0.004}, **kw)
    c = _gen_fault_schedule(8, 2, 4000, {"exception": 0.004}, **kw)
    assert a == b
    assert a["faults"] != c["faults"]
    pre = sum(1 for r in a["faults"].values() for s in r if int(s) < 1000)
    post = sum(1 for r in a["faults"].values() for s in r if int(s) >= 1000)
    assert post > pre, (pre, post)


def test_soak_smoke_fault_shift_goodput_ab():
    """Both arms replay ONE seeded fault schedule; the adaptive arm closes
    the loop (estimator -> Young/Daly cadence -> SaveScheduler) on real
    telemetry.  The reference's assertions: the report's ok (the 1.1x gain
    gate, waived on 1-core hosts), both arms ok, a finite gain, both
    progresses > 0."""
    report = _soak("--fault-shift", "--seconds", "20", "--fault-seed", "11")
    assert report["ok"], report
    assert report["arms_ok"], report
    assert report["policy_goodput_gain"] > 0, report
    assert report["fixed_progress"] > 0, report
    assert report["adaptive_progress"] > 0, report
