"""Chaos soak: the port's whole resiliency stack under randomized faults.

The port of ``benchmarks/soak_launcher.py``, the JAX package's regression
gate, with its flags by their names.  Stack under test: the port's launcher
and rank monitors, the rendezvous and KV store (in the launcher, or the
port's external control plane with a journal), the in-process ``Wrapper``
ring and the quorum tripwire, with four randomized fault classes injected
per worker step (``soak/workloads/main.py``):

- ``exception`` — absorbed by the in-process ring (no respawn);
- ``quorum_stall`` / ``collective_wedge`` (``--quorum``) — a ping-less
  stall; the quorum tripwire's tick lane trips, every rank's abort ladder
  runs (its fingerprint rung must release) and the iteration restarts;
- ``hang`` — a GIL-released sleep; the rank monitor's heartbeat timeout
  kills the worker (outer ring respawn);
- ``crash`` — hard exit (outer ring respawn).

With ``--chaos-store`` the store is the port's control plane
(``python -m tpu_resiliency_torch.fault_tolerance.control_plane
--journal``), SIGKILLed and restarted at random intervals by
:class:`StoreChaos`; with ``--store-kill-mid-save`` the kills land inside
rank 0's store-backed saves, and every started save must complete.  The
other campaigns, each with its own workload under ``soak/workloads/``:
``--corrupt-blob {bitflip,truncate}`` and ``--peer-mem-kill``
(``lckpt.py``), ``--link-degrade`` (``coll.py``), ``--ramp-degrade``
(``evac.py``), ``--store-longpoll-abort`` (``longpoll.py``), and
``--fault-shift``, the adaptive-vs-fixed goodput A/B over one seeded fault
schedule (:func:`_run_fault_shift_ab`, each arm a ``--goodput-arm`` run of
``goodput.py``).

Every process appends profiling events to one JSONL
(``TPURX_PROFILING_FILE``); :func:`~.report.build_report` derives both
rings' detect->recover latencies from it, asserts their bounds and each
campaign's checks, and the soak prints the report as its last line and
exits with its verdict.

Device rule: the workers run on the CUDA card (``SOAK_DEVICE=cuda``)
unless ``--device cpu`` is given.  Without a card and without that flag the
soak exits non-zero before it spawns anything.  On every exit path the
soak kills its launcher's session, its store host's and any worker process
left, so no soak process holds the card after it returns.

    python -m tpu_resiliency_torch.soak --gate          # the 15-minute gate
    python -m tpu_resiliency_torch.soak --seconds 45 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

from .report import LP_POLL_S, build_report
from .schedule import _gen_fault_schedule
from .worker import read_counts, read_progress

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKLOADS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "workloads")
OUTPUT_TAIL = 12000   # chars of the launcher's output a failed run prints


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _kill_session(proc) -> None:
    """SIGKILL what is left of ``proc``'s session (a session leader)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def _stop_child(proc, grace: float = 60.0) -> None:
    """Stop a soak run started in a session of its own: SIGTERM lets it
    clean up its own process tree (its launcher's, store host's and
    workers' sessions), SIGKILL of its session follows after ``grace``."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            pass
    _kill_session(proc)


def _kill_leftover_workers(counts_dir: str) -> list:
    """SIGKILL every worker that wrote counts under ``counts_dir`` and is
    still alive (workers run in sessions of their own, so the launcher's
    session kill does not reach one the launcher left behind).  A pid is
    only killed when its environment names ``counts_dir``."""
    killed = []
    marker = f"SOAK_COUNTS_DIR={counts_dir}".encode()
    for rec in read_counts(counts_dir):
        pid = int(rec.get("pid", 0))
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker not in f.read().split(b"\0"):
                    continue
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)
        except (OSError, ValueError):
            continue
    return killed


class StoreChaos(threading.Thread):
    """Kill and restart the external control plane — at random intervals,
    or (``trigger`` given) the moment the trigger fires, so kills can be
    TARGETED inside a save window (store-outage-mid-save)."""

    def __init__(self, spawn_fn, min_s: float, max_s: float, down_s: float,
                 trigger=None):
        super().__init__(daemon=True)
        self.spawn_fn = spawn_fn
        self.min_s, self.max_s, self.down_s = min_s, max_s, down_s
        self.trigger = trigger
        self.proc = spawn_fn()
        self.kills = 0
        self._halt = threading.Event()
        self.rng = random.Random(0xC4A05)

    def _wait_for_next_kill(self) -> bool:
        """True when a kill is due; False when halting."""
        if self.trigger is None:
            return not self._halt.wait(self.rng.uniform(self.min_s, self.max_s))
        while not self._halt.is_set():
            if self.trigger():
                return True
            if self._halt.wait(0.2):
                break
        return False

    def run(self):
        while not self._halt.is_set():
            if not self._wait_for_next_kill():
                break
            try:
                os.kill(self.proc.pid, signal.SIGKILL)
                self.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass
            self.kills += 1
            print(f"soak: store host KILLED (#{self.kills})", flush=True)
            if self._halt.wait(self.down_s):
                break
            self.proc = self.spawn_fn()
            print("soak: store host restarted", flush=True)

    def stop(self):
        # join BEFORE terminating: run() may be mid-respawn, and killing the
        # old proc while it assigns a fresh one would leak an orphan store
        self._halt.set()
        self.join(timeout=15)
        try:
            self.proc.terminate()
            self.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass
        _kill_session(self.proc)


def _run_fault_shift_ab(args) -> int:
    """Adaptive-vs-fixed goodput A/B: both arms replay ONE seeded fault
    schedule (same injection timeline) for the same wall time; goodput is
    durably-saved progress.  Reports ``policy_goodput_gain`` =
    adaptive / fixed, gated at 1.1x (waived on 1-core hosts, where two
    gangs + monitors thrash a single CPU)."""
    workdir = tempfile.mkdtemp(prefix="tpurx-soak-ab-")
    try:
        sched_path = args.fault_schedule
        if sched_path is None:
            seed = args.fault_seed if args.fault_seed is not None else 0x600D
            step_s = 0.02
            horizon = max(400, int(args.seconds / step_s) * 2)
            sched = _gen_fault_schedule(
                seed, args.nproc, horizon, {"exception": 0.004},
                shift_at=horizon // 4, shift_mult=6.0,
            )
            sched_path = os.path.join(workdir, "fault_schedule.json")
            with open(sched_path, "w") as f:
                json.dump(sched, f)
        arms: dict = {}
        for arm in ("fixed", "adaptive"):
            cmd = [
                sys.executable, "-m", "tpu_resiliency_torch.soak",
                "--seconds", str(args.seconds),
                "--nproc", str(args.nproc),
                "--fault-schedule", os.path.abspath(sched_path),
                "--goodput-arm", arm,
                *(["--device", args.device] if args.device else []),
            ]
            env = dict(os.environ)
            env.update({
                "TPURX_POLICY": "1" if arm == "adaptive" else "0",
                "TPURX_POLICY_INTERVAL_S": "2.0",
                # the Young/Daly optimum here lives in single-digit seconds;
                # production clamp floors would pin the controller
                "TPURX_POLICY_CADENCE_MIN_S": "0.5",
                "TPURX_POLICY_CADENCE_MAX_S": "60.0",
            })
            proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    start_new_session=True)
            try:
                stdout, _ = proc.communicate(timeout=args.seconds + 240.0)
            except subprocess.TimeoutExpired:
                _stop_child(proc)
                stdout, _ = proc.communicate()
            finally:
                _stop_child(proc)
            last = [line for line in stdout.splitlines() if line.startswith("{")]
            arms[arm] = (
                json.loads(last[-1]) if last
                else {"ok": False, "final_progress": 0}
            )
            print(f"soak-ab[{arm}]: final={arms[arm].get('final_progress')} "
                  f"ok={arms[arm].get('ok')}", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    fixed_g = max(1, int(arms["fixed"].get("final_progress") or 0))
    adaptive_g = int(arms["adaptive"].get("final_progress") or 0)
    gain = adaptive_g / fixed_g
    waived = (os.cpu_count() or 1) <= 1
    arms_ok = bool(arms["fixed"].get("ok") and arms["adaptive"].get("ok"))
    ok = arms_ok and (waived or gain >= 1.1)
    print(json.dumps({
        "metric": "soak_fault_shift",
        "seconds_per_arm": args.seconds,
        "fault_schedule": os.path.abspath(sched_path),
        "adaptive_progress": adaptive_g,
        "fixed_progress": fixed_g,
        "policy_goodput_gain": round(gain, 3),
        "policy_gate_waived": waived,
        "arms_ok": arms_ok,
        "arms": {arm: {k: arms[arm].get(k) for k in (
            "final_progress", "cycles", "inner_ring_recoveries", "worker_devices")}
            for arm in arms},
        "ok": ok,
    }), flush=True)
    return 0 if ok else 1


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m tpu_resiliency_torch.soak",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seconds", type=float, default=120.0)
    p.add_argument("--gate", action="store_true",
                   help="the regression gate: 900s, chaos-store, quorum")
    p.add_argument("--exc-p", type=float, default=0.01)
    p.add_argument("--crash-p", type=float, default=0.008)
    p.add_argument("--hang-p", type=float, default=0.004)
    p.add_argument("--qstall-p", type=float, default=0.006)
    p.add_argument("--cwedge-p", type=float, default=0.004,
                   help="wedged-collective injection probability "
                        "(quorum-armed runs only)")
    p.add_argument("--save-every", type=int, default=0,
                   help="steps between rank-0 store-backed saves (0=off)")
    p.add_argument("--store-kill-mid-save", action="store_true",
                   help="target store kills INSIDE save windows; asserts "
                        "every started save still completes")
    p.add_argument("--corrupt-blob", choices=("bitflip", "truncate"),
                   help="checkpoint-integrity campaign: corrupt every copy "
                        "of the newest local-checkpoint iteration mid-run; "
                        "the restarted gang must fallback-restore the "
                        "next-oldest valid iteration")
    p.add_argument("--peer-mem-kill", action="store_true",
                   help="warm-restore campaign: stall the peer-memory "
                        "serving rank mid-restore drill; the other ranks' "
                        "ladders must fall through to their own disk with "
                        "fallback depth 0")
    p.add_argument("--ramp-degrade", action="store_true",
                   help="predict-and-evacuate campaign: one rank's health "
                        "and straggler scores ramp worse round by round; "
                        "the policy's fused rank risk must EVACUATE it "
                        "before its hard-fault deadline, and never evacuate "
                        "a healthy rank")
    p.add_argument("--link-degrade", action="store_true",
                   help="self-healing-collectives campaign: one rank's "
                        "primary collective lane is fault-armed to stall "
                        "past its deadline (TPURX_FAULT=coll_stall); the "
                        "wrapper must degrade (retry -> re-layout) and the "
                        "job must finish with ZERO launcher-ring restarts")
    p.add_argument("--store-longpoll-abort", action="store_true",
                   help="interruptible-long-poll campaign: each restart "
                        "episode parks one rank in a server-held store "
                        "wait() and injects a sibling fault; the async "
                        "abort must LAND on the parked rank within the "
                        "poll-quantum contract and no rank may exit ret=None")
    p.add_argument("--longpoll-bound-s", type=float, default=None,
                   help="bound on injection->landing latency per episode "
                        "(default: abort-propagation budget + 2x "
                        "TPURX_STORE_POLL_S)")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="derive a deterministic per-(rank,step) fault "
                        "schedule from this seed and replay it (each "
                        "scheduled injection fires exactly once) instead "
                        "of per-step RNG draws")
    p.add_argument("--fault-schedule", default=None,
                   help="replay an exact recorded schedule file "
                        "(overrides --fault-seed generation)")
    p.add_argument("--fault-shift", action="store_true",
                   help="adaptive-vs-fixed goodput A/B under ONE seeded "
                        "fault schedule whose fault rate steps up "
                        "mid-run; reports policy_goodput_gain")
    p.add_argument("--goodput-arm", choices=("adaptive", "fixed"),
                   default=None, help=argparse.SUPPRESS)  # one A/B arm
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--native-store", action="store_true")
    p.add_argument("--chaos-store", action="store_true",
                   help="external journaled control plane, randomly killed")
    p.add_argument("--quorum", action="store_true",
                   help="arm the quorum tripwire in the workload")
    p.add_argument("--store-kill-every", type=float, nargs=2,
                   default=(35.0, 70.0), metavar=("MIN", "MAX"))
    p.add_argument("--store-down", type=float, default=3.0)
    p.add_argument("--inner-bound-ms", type=float, default=8000.0,
                   help="bound on median inner-ring detect->recover")
    p.add_argument("--outer-bound-ms", type=float, default=30000.0,
                   help="bound on median outer-ring detect->recover")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the workers run (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.gate:
        args.seconds = max(args.seconds, 900.0)
        args.chaos_store = True
        args.quorum = True
        args.store_kill_mid_save = True
        if not args.save_every:
            args.save_every = 60
    if args.store_kill_mid_save:
        args.chaos_store = True
        if not args.save_every:
            args.save_every = 40
    return args


def _workload(args) -> str:
    if args.goodput_arm:
        name = "goodput"
    elif args.store_longpoll_abort:
        name = "longpoll"
    elif args.ramp_degrade:
        name = "evac"
    elif args.link_degrade:
        name = "coll"
    elif args.corrupt_blob or args.peer_mem_kill:
        name = "lckpt"
    else:
        name = "main"
    return os.path.join(WORKLOADS, f"{name}.py")


def _campaign_env(args, workdir: str) -> dict:
    """The workers' environment: the caller's, plus the soak's knobs and
    each campaign's."""
    env = dict(os.environ)
    env.update({
        "TPURX_REPO": REPO,
        "SOAK_DEVICE": args.device or "cuda",
        "SOAK_COUNTS_DIR": os.path.join(workdir, "counts"),
        "SOAK_CKPT": os.path.join(workdir, "progress.txt"),
        "SOAK_EXC_P": str(args.exc_p),
        "SOAK_CRASH_P": str(args.crash_p),
        "SOAK_HANG_P": str(args.hang_p),
        "SOAK_QSTALL_P": str(args.qstall_p if args.quorum else 0.0),
        "SOAK_CWEDGE_P": str(args.cwedge_p if args.quorum else 0.0),
        "SOAK_SAVE_EVERY": str(args.save_every),
        "SOAK_QUORUM": "1" if args.quorum else "0",
        "TPURX_PROFILING_FILE": os.path.join(workdir, "profile.jsonl"),
        "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "0",
        "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": "3.0",
        "TPURX_FT_INITIAL_RANK_HEARTBEAT_TIMEOUT": "60.0",
        "TPURX_FT_WORKLOAD_CHECK_INTERVAL": "0.2",
        "TPURX_FT_WORKERS_STOP_TIMEOUT": "3.0",
        "TPURX_FT_MAX_NO_PROGRESS_CYCLES": "0",  # chaos: no early stop
        "TPURX_FT_STORE_REJOIN_WINDOW": "120.0",
    })
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"   # several workers beside each other on one host
    if args.corrupt_blob or args.peer_mem_kill:
        env.update({
            "SOAK_CKPT_ROOT": os.path.join(workdir, "lckpt"),
            "SOAK_LCKPT_EVERY": "10",
            # barriers/replication pause heartbeats briefly; keep the kill
            # threshold clear of normal collective latency
            "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": "10.0",
        })
    if args.corrupt_blob:
        env.update({
            "SOAK_CORRUPT_MODE": args.corrupt_blob,
            "SOAK_CORRUPT_STEP": "35",
        })
    if args.peer_mem_kill:
        env.update({
            "SOAK_PEER_DRILL_STEP": "25",
            # arm the stall fault on the SERVING rank only: rank 0 keeps
            # its resident copy (so its advert attracts probes) but drops
            # every peer-memory request it receives
            "TPURX_FAULT": "peer_mem_stall",
            "TPURX_FAULT_RANKS": "0",
            "TPURX_CKPT_PEER_MEM_TIMEOUT": "2.0",
        })
        if not args.corrupt_blob:
            env["SOAK_CORRUPT_STEP"] = "-1"  # drill only, no corruption leg
    if args.ramp_degrade:
        env.update({
            "SOAK_CKPT_ROOT": os.path.join(workdir, "lckpt"),
            "SOAK_LCKPT_EVERY": "5",
            "SOAK_EVAC_VICTIM": "1",
            "SOAK_EVAC_RAMP_ROUNDS": "12",
            "SOAK_EVAC_DEADLINE": "45",
            "TPURX_EVAC": "1",
            # saves/tree rounds/joins pause heartbeats briefly
            "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": "15.0",
        })
    if args.store_longpoll_abort:
        env.update({
            # a visible (but short) quantum so the landing-latency numbers
            # actually exercise the slicing, not sub-millisecond noise
            "TPURX_STORE_POLL_S": str(LP_POLL_S),
            "SOAK_LP_INJECT_DELAY": "2.0",
            # the parked rank legitimately skips rank-monitor heartbeats
            # while inside wait(); keep the outer ring's kill threshold
            # clear of a whole episode
            "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": "30.0",
        })
    if args.link_degrade:
        env.update({
            # stall rank 0's PRIMARY collective lane past its deadline;
            # fallback lanes stay healthy so the degrade ladder can land
            "TPURX_FAULT": "coll_stall",
            "TPURX_FAULT_RANKS": "0",
            "TPURX_COLL_DEADLINE_MS": "300",
            "TPURX_COLL_RETRIES": "1",
            "SOAK_COLL_STEPS": "25",
            # the first degraded call eats ~2 deadlines + a re-layout;
            # keep the heartbeat kill threshold well clear of that
            "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": "10.0",
        })
    if args.native_store:
        env["TPURX_NATIVE_STORE"] = "1"
    return env


def _read_events(profile: str) -> list:
    events = []
    try:
        with open(profile) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return events


def _run(args, workdir: str) -> tuple:
    """One soak run in ``workdir``: the report dict and the launcher's
    output."""
    env = _campaign_env(args, workdir)
    os.makedirs(env["SOAK_COUNTS_DIR"])
    ckpt = env["SOAK_CKPT"]
    journal = os.path.join(workdir, "store.journal")
    port = _free_port()
    sched_path = args.fault_schedule
    if sched_path is None and (args.fault_seed is not None or args.goodput_arm):
        sched = _gen_fault_schedule(
            args.fault_seed if args.fault_seed is not None else 0x600D,
            args.nproc, 20000,
            {"exception": args.exc_p, "crash": args.crash_p,
             "hang": args.hang_p},
        )
        sched_path = os.path.join(workdir, "fault_schedule.json")
        with open(sched_path, "w") as f:
            json.dump(sched, f)
    if sched_path is not None:
        fired = os.path.join(workdir, "fault_fired")
        os.makedirs(fired, exist_ok=True)
        env["SOAK_FAULT_SCHEDULE"] = os.path.abspath(sched_path)
        env["SOAK_FAULT_FIRED_DIR"] = fired
        with open(sched_path) as f:
            n_sched = sum(len(v) for v in json.load(f)["faults"].values())
        print(f"soak: replaying fault schedule {sched_path} "
              f"({n_sched} scheduled injections)", flush=True)

    chaos = None
    proc = None
    chunks: list = []   # launcher stdout, drained continuously (shared with
    # the mid-save trigger, which scans it for save-start markers)
    launch_cmd = [
        sys.executable, "-m", "tpu_resiliency_torch.fault_tolerance.launcher",
        "--nnodes", "1", "--nproc-per-node", str(args.nproc),
        "--rdzv-endpoint", f"127.0.0.1:{port}",
        "--max-restarts", "0",   # unlimited
        "--monitor-interval", "0.05",
    ]
    progress_samples = []
    try:
        if args.chaos_store:
            def spawn_store():
                cmd = [
                    sys.executable, "-m",
                    "tpu_resiliency_torch.fault_tolerance.control_plane",
                    "--host", "127.0.0.1", "--port", str(port),
                    "--journal", journal,
                ]
                if args.native_store:
                    cmd.append("--native-store")
                return subprocess.Popen(cmd, env=env, cwd=REPO,
                                        stdout=subprocess.DEVNULL,
                                        stderr=subprocess.STDOUT,
                                        start_new_session=True)

            trigger = None
            if args.store_kill_mid_save:
                state = {"last": 0, "next_kill_t": 0.0}

                def trigger():
                    # fire INSIDE a save window: a fresh "save start" marker,
                    # rate-limited so some saves also complete undisturbed
                    starts = "".join(chunks).count("] save start at step")
                    now = time.monotonic()
                    if starts > state["last"]:
                        state["last"] = starts
                        if starts % 2 == 1 and now >= state["next_kill_t"]:
                            state["next_kill_t"] = now + 12.0
                            return True
                    return False

            chaos = StoreChaos(spawn_store, *args.store_kill_every,
                               down_s=args.store_down, trigger=trigger)
            time.sleep(2.0)  # let the control plane bind before launchers dial
        else:
            launch_cmd.append("--host-store")
        launch_cmd.append(_workload(args))

        proc = subprocess.Popen(
            launch_cmd, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True,
        )
        # drain stdout continuously: a full 64KB pipe would block the
        # launcher and wedge the very run being measured

        def _drain():
            for line in proc.stdout:
                chunks.append(line)

        reader = threading.Thread(target=_drain, daemon=True)
        reader.start()
        if chaos is not None:
            chaos.start()
        deadline = time.monotonic() + args.seconds
        while time.monotonic() < deadline and proc.poll() is None:
            time.sleep(5.0)
            progress_samples.append(read_progress(ckpt))
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()  # never leak the launcher tree from the soak itself
            proc.wait(timeout=10)
        reader.join(timeout=10)
    finally:
        if proc is not None:
            _kill_session(proc)
        if chaos is not None:
            chaos.stop()
        leftover = _kill_leftover_workers(env["SOAK_COUNTS_DIR"])
        if leftover:
            print(f"soak: killed leftover workers {leftover}", flush=True)

    end_debris = 0
    if args.corrupt_blob:
        import glob

        end_debris = len(glob.glob(
            os.path.join(workdir, "lckpt", "**", "*.corrupt"), recursive=True))
    report = build_report(
        chunks, _read_events(env["TPURX_PROFILING_FILE"]), progress_samples, args,
        launcher_pid=proc.pid, store_kills=chaos.kills if chaos else 0,
        end_debris=end_debris, worker_counts=read_counts(env["SOAK_COUNTS_DIR"]),
    )
    return report, "".join(chunks)


def _check_device(args) -> bool:
    if args.device == "cpu":
        return True
    import torch

    if torch.cuda.is_available():
        return True
    print("soak: no CUDA device is available; pass --device cpu to run the "
          "workers on the CPU", file=sys.stderr)
    return False


def main(argv=None) -> int:
    args = parse_args(argv)
    if not _check_device(args):
        return 2
    # a SIGTERM (a caller's timeout) still runs every clean-up below
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.fault_shift:
        return _run_fault_shift_ab(args)
    workdir = tempfile.mkdtemp(prefix="tpurx-soak-")
    try:
        report, output = _run(args, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if not report["ok"]:
        # the run's own words for a failed verdict (the report is the last line)
        print(f"soak: the launcher's output, last {OUTPUT_TAIL} chars:\n"
              f"{output[-OUTPUT_TAIL:]}", file=sys.stderr, flush=True)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1
