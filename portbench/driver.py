"""One run of a training cell: the port's trainer under its always-on set.

Set-up builds one trainer (the port's ``make_train_step`` over weights
drawn here from the seed), and the port's documented always-on set around
it, in a world of one process over NCCL:

- the in-process restart ring (``inprocess.Wrapper``) with its monitor
  process (soft and hard timeouts), its monitor thread, the port's health
  probe and the default abort ladder;
- both quorum lanes over the ring's process group: ``FusedStepQuorum``
  riding every step and ``QuorumMonitor``'s tick lane (kernel 1);
- the straggler ``Detector`` with its always-on ``OpCollector``, at its
  default intervals, around every step.

The traffic file says what the window holds: a checkpoint committed
before the warm-up (``save_step``) and a fault timeline (``faults``), or
neither.  The warm-up's steps go through the window's own call and feed;
the program's readings that the reference checks are taken from them.
Each fault is injected by the module of its class (``portbench/faults/``),
and each restart restores the committed save through the port's default
restore path and replays from it.

What the window recorded is a :class:`Run`, which the metric readers and
the comparison read once the window has closed.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import faults, feed, schedule, spec, weights

# the quorum lanes' budget: above the longest step of any cell (the fused
# lane's readback waits for the previous step under a deadline of four
# budgets) and under the packed age cap (1.07 s); the tick lane keeps it
QUORUM_BUDGET_MS = 500.0
QUORUM_INTERVAL_S = 0.01
QUORUM_AUTO_BEAT_S = 0.005


class Run:
    """What one run recorded; the metric readers and the check read it."""

    def __init__(self, config: dict, traffic: dict, t_start: float):
        self.traffic = traffic
        self.model = config["model"]
        self.rows, self.seq = config["batch"], config["seq"]
        self.t_start = t_start           # perf_counter at the process's start
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.steps = 0                   # steps completed in the window
        self.step_gaps_ms: List[float] = []
        self.faults: List[Dict[str, Any]] = []
        self.errors: List[str] = []      # exceptions no fault injected
        self.false_trips = 0             # restarts no injected fault caused
        self.aborted: Optional[str] = None
        self.spans: List[tuple] = []     # (name, start, end) on time.time_ns
        self.trace = None                # trace.Trace of the window
        self.memory_peak_bytes = 0
        self.quorum_n_local = 1
        # program readings for the comparison
        self.losses: List[float] = []            # warm-up steps 1..3
        self.replay_losses: List[List[float]] = []
        self.grad_norm: List[float] = []
        self.grad_first: List[torch.Tensor] = []  # step 1's gradients, host
        self.change_norm: List[float] = []
        self.restore_mismatch: List[int] = []
        self.shm_left: List[str] = []
        self.marks: List[tuple] = []     # (set-up stage, s since t_start)

    @property
    def tokens(self) -> int:
        return self.steps * self.rows * self.seq


def _shm() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


def program_step(model: dict, lr: float, dtype: torch.dtype) -> Tuple[Callable, Any]:
    """The port's train step for the configuration, what the window drives,
    and the port's ``TransformerConfig`` it was made for."""
    from tpu_resiliency_torch.models import transformer as tr

    cfg = tr.TransformerConfig(
        vocab=model["vocab"], d_model=model["d_model"], n_heads=model["n_heads"],
        n_layers=model["n_layers"], d_ff=model["d_ff"], max_seq=model["max_seq"],
        dtype=dtype)
    return tr.make_train_step(cfg, lr=lr), cfg


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None) -> Run:
    """Set up, run the window, tear the program down; returns the record."""
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import resident
    from tpu_resiliency_torch.inprocess import (
        AbortCheckpointWorkers,
        AbortQuorumMonitor,
        DeviceProbeHealthCheck,
        Wrapper,
        default_ladder,
    )
    from tpu_resiliency_torch.inprocess.exceptions import RestartAbort
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.parallel import distributed as dist_mod
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.store import StoreFactory, StoreServer
    from tpu_resiliency_torch.straggler import Detector

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rec = Run(config, traffic, time.perf_counter() if t_start is None else t_start)
    dtype = getattr(torch, config["dtype"])
    # the port's AdamW constants are fixed in make_train_step; the reference
    # the configuration names holds the same ones
    b1 = spec.reference(config).B1
    model = rec.model
    wall_minus_mono = time.time_ns() - time.monotonic_ns()

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def mark(stage):
        rec.marks.append((stage, round(time.perf_counter() - rec.t_start, 3)))

    def span(name, t0_ns, t1_ns=None):
        rec.spans.append((name, t0_ns, time.time_ns() if t1_ns is None else t1_ns))

    shm_before = _shm()
    root = tempfile.mkdtemp(prefix="portbench-")
    os.environ["TPURX_FLIGHT_DIR"] = os.path.join(root, "flight")
    plan = schedule.fault_times(traffic.get("faults"), seed, seconds)
    save_step = traffic.get("save_step")
    warmup = int(traffic["warmup_steps"])
    save_dir = os.path.join(root, "ckpt")

    mark("imported")
    plain_step, tcfg = program_step(model, config["lr"], dtype)
    params = tr.Transformer(tcfg, weights.make(model, seed, dev, dtype))
    got = [n for n, _ in params.named_parameters()]
    if got != weights.names(model):
        raise RuntimeError(f"the port's parameters are not in the order the "
                           f"harness reads them: {got[:6]} ...")
    opt = tr.init_opt_state(params)
    st = {"params": params, "opt": opt}
    recorder = None
    if trace:
        from .trace import Recorder

        recorder = Recorder()

    mark("weights")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    ck = ckpt_mod.AsyncCheckpointer() if save_step is not None else None
    det = Detector(device=device)
    det.initialize()
    inner = det.wrap_callables({"train_step": plain_step})["train_step"]
    probe = DeviceProbeHealthCheck(device=None if on_card else "cpu")
    w: Dict[str, Any] = {"k": 0, "t0": None, "deadline": None, "next": 0,
                         "init_s": [], "events": [], "replay": None}

    def initialize(state):
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        init_distributed(device=dev)
        w["init_s"].append(time.perf_counter() - t0)
        span("initialize", t0_ns)

    def readings_step1():
        norms = []
        with torch.no_grad():
            for m in opt["mu"]:  # one leaf at a time: no second copy on the card
                g = m / (1 - b1)
                norms.append(torch.linalg.vector_norm(g))
                # kept on the host for the reference's leaf-by-leaf difference
                rec.grad_first.append(g.to("cpu"))
            rec.grad_norm = torch.stack(norms).tolist()

    def readings_change():
        masters = opt.get("master") or list(params.parameters())
        start = weights.leaves(weights.make(model, seed, dev, dtype))
        with torch.no_grad():
            rec.change_norm = torch.stack(
                [torch.linalg.vector_norm(m - s.to(torch.float32))
                 for m, s in zip(masters, start)]).tolist()

    def restored_mismatch() -> torch.Tensor:
        """Elements of the restored state that differ from the committed
        save of step 0, which is the seed's starting state."""
        start = weights.leaves(weights.make(model, seed, dev, dtype))
        n = torch.zeros((), dtype=torch.int64, device=dev)
        masters = opt.get("master") or [None] * len(start)
        with torch.no_grad():
            for p, s, mu, nu, m in zip(params.parameters(), start, opt["mu"],
                                       opt["nu"], masters):
                n += torch.count_nonzero(p != s)
                n += torch.count_nonzero(mu) + torch.count_nonzero(nu)
                if m is not None:
                    n += torch.count_nonzero(m != s.to(torch.float32))
            n += torch.count_nonzero(opt["count"])
        return n

    def after_fault(cw):
        it = cw.iteration
        if not rec.faults or rec.faults[-1]["iteration"] != it - 1:
            rec.false_trips += 1
            rec.faults.append({"iteration": it - 1, "class": "unexpected",
                               "t_ns": cw.trip_ns.get(it - 1, time.monotonic_ns()),
                               "injected": False})
        f = rec.faults[-1]
        trip = cw.trip_ns.get(it - 1)
        if trip is not None:
            f["detect_ms"] = (trip - f["t_ns"]) / 1e6
            span("detect", f["t_ns"] + wall_minus_mono, trip + wall_minus_mono)
        f["abort_ms"] = sum(r.duration_ms for r in cw.last_ladder_results)
        f["ladder"] = {r.stage: r.outcome for r in cw.last_ladder_results}
        if trip is not None:
            span("abort", trip + wall_minus_mono,
                 trip + wall_minus_mono + int(f["abort_ms"] * 1e6))
        if save_step is None:
            return  # nothing committed to restore: train on from where it was
        # a checkpoint load is a known-long phase: the port's documented
        # guard keeps the lanes from reading it as a hang
        with cw.disable_hang_protection():
            t0 = time.perf_counter()
            t0_ns = time.time_ns()
            out = ckpt_mod.load_checkpoint(save_dir, tr.state_tree(params, opt))
            tr.load_state_tree(params, opt, out)
            del out
            sync()
            f["init_ms"] = w["init_s"][-1] * 1e3
            f["load_ms"] = (time.perf_counter() - t0) * 1e3
            f["restore_ms"] = f["init_ms"] + f["load_ms"]
            span("restore", t0_ns)
            span("restart", f["t_ns"] + wall_minus_mono)
            t0_ns = time.time_ns()
            w["checks"].append(restored_mismatch())
            span("restore_check", t0_ns)
        f["restarted"] = True
        w["k"] = save_step
        w["replay"] = []
        rec.replay_losses.append(w["replay"])

    def fire(cw, cls: str):
        rec.faults.append({"iteration": cw.iteration, "class": cls,
                           "t_ns": time.monotonic_ns(), "injected": True})
        faults.fire(cls, cw, w["k"])

    def one_step(cw, step_fn):
        k = w["k"] + 1
        tokens, targets = feed.batch(model, seed, k, rec.rows, rec.seq, dev)
        cw.ping()
        t0_ns = time.time_ns()
        with det.detection_section("step"):
            st["params"], st["opt"], loss = step_fn(st["params"], st["opt"],
                                                    (tokens, targets))
        span("step", t0_ns)
        w["k"] = k
        t0_ns = time.time_ns()
        det.maybe_report()
        span("report", t0_ns)
        return k, loss

    def trainer(cw):
        it = cw.iteration
        if it > 0:
            if w["t0"] is None:
                return "no window"  # set-up failed; the ring restarted it
            if rec.window_s is not None:
                return "done"  # a restart after the window closed (a false trip)
            after_fault(cw)
        step_fn = cw.quorum.fuse(inner)
        if it == 0:
            rec.quorum_n_local = cw.quorum.fused.n_local
            if save_step is not None:
                ck.async_save(tr.state_tree(params, opt), save_dir,
                              {"step": save_step})
            mark("ring")
            for _ in range(warmup):
                k, loss = one_step(cw, step_fn)
                rec.losses.append(float(loss))
                if k == 1:
                    readings_step1()
            mark("warmup")
            readings_change()
            mark("readings")
            if ck is not None:
                ck.maybe_finalize(blocking=True)
                mark("save_committed")
            sync()
            rec.setup_s = time.perf_counter() - rec.t_start
            if recorder is not None:
                recorder.start()
            w["t0"] = time.perf_counter()
            w["deadline"] = w["t0"] + seconds
            if on_card:
                w["events"].append(torch.cuda.Event(enable_timing=True))
                w["events"][-1].record()
        while True:
            now = time.perf_counter()
            # a fault due inside the window fires at the first step after
            # its time, after the deadline too if a restart ran past it, so
            # every run injects the whole timeline
            if w["next"] < len(plan) and now >= w["t0"] + plan[w["next"]][0]:
                w["next"] += 1
                fire(cw, plan[w["next"] - 1][1])
            if now >= w["deadline"]:
                break
            k, loss = one_step(cw, step_fn)
            rec.steps += 1
            if w["replay"] is not None and len(w["replay"]) < len(rec.losses):
                w["replay"].append(loss)
            if on_card:
                w["events"].append(torch.cuda.Event(enable_timing=True))
                w["events"][-1].record()
            else:
                w["events"].append(time.perf_counter())
        sync()
        rec.window_s = time.perf_counter() - w["t0"]
        if recorder is not None:
            # reading a window's trace holds the interpreter for seconds:
            # the harness's own long phase, not a hang of the program
            with cw.disable_hang_protection():
                rec.trace = recorder.stop()
        step_fn.check_now()
        return "done"

    def train(call_wrapper=None):
        try:
            return trainer(call_wrapper)
        except faults.InjectedFault:
            raise
        except Exception as exc:
            rec.errors.append(f"iteration {call_wrapper.iteration}: {exc!r}")
            raise

    w["checks"] = []
    stages = [AbortCheckpointWorkers(ck.queue)] if ck is not None else []
    wrapper = Wrapper(
        store_factory=StoreFactory("127.0.0.1", server.port, timeout=60.0),
        initialize=initialize,
        abort=default_ladder(None, None, None, *stages, AbortQuorumMonitor()),
        health_check=probe,
        quorum_mesh=lambda: make_mesh(("all",), device=dev),
        quorum_budget_ms=QUORUM_BUDGET_MS, quorum_interval=QUORUM_INTERVAL_S,
        quorum_auto_beat_interval=QUORUM_AUTO_BEAT_S, quorum_calibrate=False,
        max_iterations=len(plan) + 2,
    )
    os.environ["TPURX_RANK"], os.environ["TPURX_WORLD_SIZE"] = "0", "1"
    try:
        wrapper(train)()
    except RestartAbort as exc:
        rec.aborted = repr(exc)
    finally:
        if recorder is not None and recorder.t0_ns is not None and rec.trace is None:
            recorder.stop()  # the window did not close: nothing is read from it
        if on_card:
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        ev = w["events"]
        if on_card and len(ev) > 1:
            rec.step_gaps_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        elif len(ev) > 1:
            rec.step_gaps_ms = [(b - a) * 1e3 for a, b in zip(ev, ev[1:])]
        rec.replay_losses = [[float(x) for x in r] for r in rec.replay_losses]
        rec.restore_mismatch = [int(n) for n in w["checks"]]
        st.clear()
        del params, opt
        if ck is not None:
            ck.close()
            resident.invalidate()
        det.shutdown()
        server.stop()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        dist_mod.reset()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        rec.shm_left = sorted(_shm() - shm_before)
    return rec

