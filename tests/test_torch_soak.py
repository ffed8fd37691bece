"""The port's chaos soak (``tpu_resiliency_torch/soak/``) against the JAX
package's ``benchmarks/soak_launcher.py``, loaded with ``importlib`` as
``tests/test_soak_smoke.py`` loads it.

- ``_gen_fault_schedule`` gives byte-identical JSON for the same (seed,
  nproc, horizon, probs, shift), the ``--fault-shift`` and ``--fault-seed``
  defaults among the cases.
- ``_ring_latencies`` gives equal lists on canned event streams
  (interleaved pids, a detection with no completion, a fallback anchor).
- The report: the reference's ``main`` runs over a canned launcher (its
  ``subprocess.Popen`` and ``StoreChaos`` replaced, its sleeps skipped), and
  the port's ``build_report`` gets the same stdout, profiling events,
  progress samples, arguments, launcher pid, store kills and debris; every
  key of the reference's report must be equal in the port's, one case per
  campaign.
- Without a card and without ``--device cpu`` the soak exits non-zero and
  spawns nothing (it makes no work directory, the first thing a run does).
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from tpu_resiliency_torch.soak import launcher as tlauncher
from tpu_resiliency_torch.soak import report as treport
from tpu_resiliency_torch.soak import schedule as tschedule

REPO = Path(__file__).resolve().parent.parent


def _reference():
    spec = importlib.util.spec_from_file_location(
        "soak_launcher_reference", str(REPO / "benchmarks" / "soak_launcher.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.mark.parametrize("seed,nproc,horizon,probs,shift", [
    # --fault-shift's defaults at 20 s an arm and at the gate's 900 s
    (0x600D, 2, 2000, {"exception": 0.004}, (500, 6.0)),
    (11, 2, max(400, int(900 / 0.02) * 2), {"exception": 0.004}, (22500, 6.0)),
    # --fault-seed / --goodput-arm's schedule at the default probabilities
    (0x600D, 2, 20000, {"exception": 0.01, "crash": 0.008, "hang": 0.004}, None),
    (7, 4, 4000, {"exception": 0.02, "crash": 0.0, "hang": 0.3}, (1000, 0.5)),
    (0, 1, 2, {"exception": 1.0}, (1, 6.0)),
])
def test_fault_schedule_is_byte_identical(seed, nproc, horizon, probs, shift):
    kw = {} if shift is None else {"shift_at": shift[0], "shift_mult": shift[1]}
    ref = REF._gen_fault_schedule(seed, nproc, horizon, probs, **kw)
    port = tschedule._gen_fault_schedule(seed, nproc, horizon, probs, **kw)
    assert json.dumps(port) == json.dumps(ref)
    assert sum(len(v) for v in port["faults"].values()) > 0


def _ev(event, pid, t_ms, **extra):
    return {"event": event, "pid": pid, "mono_ns": int(t_ms * 1e6), **extra}


def test_ring_latencies_are_equal():
    streams = [
        # interleaved worker pids, the launcher's outer pairs, a quorum trip
        [_ev("failure_detected", 10, 0), _ev("hang_detected", 21, 1),
         _ev("inprocess_interrupted", 22, 2), _ev("worker_started", 21, 3),
         _ev("inprocess_restart_completed", 22, 5), _ev("worker_started", 10, 9),
         _ev("inprocess_restart_completed", 21, 12), _ev("failure_detected", 10, 20),
         _ev("failure_detected", 10, 21), _ev("worker_started", 10, 30.5)],
        # a detection with no completion, then a completion with no detection
        [_ev("hang_detected", 5, 0), _ev("inprocess_restart_completed", 6, 4),
         _ev("failure_detected", 1, 5), _ev("worker_started", 2, 7)],
        # the fallback anchor: restart entry without a detection event, and a
        # detection that follows it (setdefault keeps the earliest)
        [_ev("inprocess_restart_started", 7, 1), _ev("hang_detected", 7, 2),
         _ev("inprocess_restart_completed", 7, 8.25),
         _ev("inprocess_restart_completed", 7, 9), _ev("worker_started", 3, 10)],
    ]
    for events in streams:
        assert tschedule._ring_latencies(events) == REF._ring_latencies(events)
    assert tschedule._ring_latencies(streams[0]) == ([9.0, 10.5], [3.0, 11.0])


LAUNCHER_PID = 4242


def _run_events(inner_ms=(250.0, 300.0, 400.0), outer_ms=(2000.0,), ladder=True):
    """A profiling stream: the launcher's cycles, inner trips in two
    worker pids (each with its ladder's stage outcomes)."""
    ev, t = [], 1000.0
    for i, dt in enumerate(outer_ms):
        ev += [_ev("worker_started", LAUNCHER_PID, t), _ev("failure_detected", LAUNCHER_PID, t + 5)]
        t += 5 + dt
    ev.append(_ev("worker_started", LAUNCHER_PID, t))
    for i, dt in enumerate(inner_ms):
        pid = 100 + i % 2
        ev.append(_ev("hang_detected" if i % 2 else "inprocess_interrupted", pid, t + 1))
        if ladder:
            ev.append(_ev("abort_stage", pid, t + 2, stage="fingerprint", outcome="released"))
        ev.append(_ev("abort_stage", pid, t + 3, stage="torch_distributed",
                      outcome="released"))
        ev.append(_ev("inprocess_restart_completed", pid, t + 1 + dt))
        t += dt + 10
    # out of order in the file: the report sorts by mono_ns
    return ev[::-1]


# (campaign, argv, stdout lines, events, progress samples, store kills,
# *.corrupt files left)
CASES = {
    "chaos_quorum": (
        ["--seconds", "50", "--chaos-store", "--quorum", "--store-kill-every", "18", "28",
         "--exc-p", "0.02", "--qstall-p", "0.012", "--cwedge-p", "0.008",
         "--inner-bound-ms", "15000", "--outer-bound-ms", "60000"],
        ["soak[0] exception at step 3\n", "soak[1] quorum stall at step 9\n",
         "soak[0] collective wedge at step 12\n", "soak[1] crash at step 20\n",
         "soak[0] hang at step 31\n", "soak[0] result=done\n"],
        _run_events(), [0, 10, 25, 25, 41], 2, 0),
    "store_kill_mid_save": (
        ["--seconds", "55", "--store-kill-mid-save", "--save-every", "30",
         "--store-down", "2.0", "--exc-p", "0", "--crash-p", "0", "--hang-p", "0"],
        ["soak[0] save start at step 30\n", "soak[0] save done at step 30\n",
         "soak[0] save start at step 60\n", "soak[0] save start at step 90\n",
         "soak[0] save start at step 120\n", "soak[0] save start at step 150\n",
         "soak[0] exception at step 151\n"],
        # the inner median over its 8000 ms bound; progress falls back once
        _run_events(inner_ms=(9000.0, 9100.0), ladder=False), [0, 30, 29, 60], 3, 0),
    "corrupt_blob": (
        ["--seconds", "45", "--corrupt-blob", "bitflip"],
        ["soaklc[0] saved iter=30\n",
         "soaklc[0] corrupted newest mode=bitflip files=4 iters=iter_30\n",
         "soaklc[0] restored iter=20 depth=1 corrupt=2 quarantined=2 debris=2\n",
         "soaklc[1] restored iter=20 depth=1 corrupt=2 quarantined=2 debris=2\n"],
        _run_events(inner_ms=(), outer_ms=(300.0,)), [0, 0, 0], 0, 2),
    "peer_mem_kill": (
        ["--seconds", "35", "--peer-mem-kill"],
        ["soaklc[0] peer-drill it=20 disk_b=0 peer_b=0 depth=0 s=0.01\n",
         "soaklc[1] peer-drill it=20 disk_b=16928 peer_b=0 depth=0 s=2.03\n"],
        _run_events(inner_ms=(), outer_ms=()), [0, 0], 0, 0),
    "link_degrade": (
        ["--seconds", "110", "--link-degrade"],
        ["soakcoll[1] result=done degrades=0 timeouts=1\n",
         "soakcoll[0] result=done degrades=25 timeouts=2\n"],
        _run_events(inner_ms=(), outer_ms=()), [0, 12, 25], 0, 0),
    "ramp_degrade": (
        ["--seconds", "120", "--ramp-degrade"],
        ["soakev[0] EVACUATE rank=1 at step=9 join_step=19\n",
         "soakev[1] JOIN warm=True iter=15 peer_b=16928 disk_b=0 dur_ms=41.2\n",
         "soakev[0] result=done joined=True\n", "soakev[1] result=done joined=True\n"],
        _run_events(inner_ms=(), outer_ms=()), [0, 0], 0, 0),
    "store_longpoll_abort": (
        ["--seconds", "12", "--store-longpoll-abort", "--longpoll-bound-s", "10.0"],
        ["soaklp[0] park ep=0 t=100.000000\n", "soaklp[1] inject ep=0 t=102.000000\n",
         "soaklp[0] landed ep=0 t=102.250000\n", "soaklp[1] park ep=1 t=103.000000\n",
         "soaklp[0] inject ep=1 t=105.000000\n", "soaklp[1] landed ep=1 t=105.300000\n",
         "soaklp[0] inject ep=2 t=108.000000\n", "soaklp[1] result=None\n"],
        _run_events(inner_ms=(300.0,), outer_ms=()), [0, 0], 0, 0),
}


class _Proc:
    """The launcher as the reference's ``main`` sees it: canned stdout, one
    progress sample written per poll, then an exit."""

    def __init__(self, lines, samples, ckpt):
        self.pid = LAUNCHER_PID
        self.stdout = iter(lines)
        self._samples, self._ckpt = list(samples), ckpt

    def poll(self):
        if self._samples:
            with open(self._ckpt, "w") as f:
                f.write(str(self._samples.pop(0)))
            return None
        return 0

    def terminate(self):
        pass

    kill = terminate

    def wait(self, timeout=None):
        return 0


@pytest.mark.parametrize("campaign", list(CASES))
def test_report_equals_the_reference(campaign, monkeypatch, capsys, tmp_path):
    argv, lines, events, samples, kills, debris = CASES[campaign]

    def popen(cmd, cwd=None, env=None, **kw):
        assert "tpu_resiliency.fault_tolerance.launcher" in cmd
        with open(env["TPURX_PROFILING_FILE"], "w") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        for i in range(debris):
            d = Path(env["SOAK_CKPT_ROOT"]) / "n0" / f"iter_{i}"
            d.mkdir(parents=True)
            (d / "blob.corrupt").write_bytes(b"x")
        return _Proc(lines, samples, env["SOAK_CKPT"])

    class Chaos:
        def __init__(self, *a, **kw):
            self.kills = kills

        start = stop = lambda self: None

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(REF.subprocess, "Popen", popen)
    monkeypatch.setattr(REF, "StoreChaos", Chaos)
    monkeypatch.setattr(REF.time, "sleep", lambda s: None)
    monkeypatch.setattr(sys, "argv", ["soak_launcher.py", *argv])
    with pytest.raises(SystemExit):
        REF.main()
    monkeypatch.undo()
    ref = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])

    args = tlauncher.parse_args([*argv, "--device", "cpu"])
    port = treport.build_report(
        lines, events, samples, args, launcher_pid=LAUNCHER_PID, store_kills=kills,
        end_debris=debris, worker_counts=[{"device": "cuda:0", "quorum_local_max": 7},
                                          {"device": "cuda:0", "quorum_local_max": 5}])
    port = json.loads(json.dumps(port))
    assert {k: port[k] for k in ref} == ref
    assert (port["kernel1_launches"], port["worker_devices"]) == (12, ["cuda:0"])
    assert ref["ok"] == (campaign not in ("store_kill_mid_save", "store_longpoll_abort"))


def test_without_a_card_the_soak_spawns_nothing(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)}
    for argv in (["--seconds", "5", "--quorum"], ["--fault-shift", "--seconds", "5"],
                 ["--gate"]):
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_resiliency_torch.soak", *argv],
            cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert "no CUDA device" in proc.stderr
        assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        assert os.listdir(tmp_path) == []
