#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_resiliency_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero):

1. setup — print the card's name and power limit, build every CUDA kernel
   from ``tpu_resiliency_torch/ops/csrc/`` (one ``nvcc`` per source, all
   started together) and print the build time and ``ptxas`` report;
2. kernel — hold both quorum local max entries against their plain
   PyTorch versions and numpy on the card, exactly: the pointer entry at
   sizes 1 .. 2^24 and start offsets 0-3, the by-value entry at n <= 32, on
   random, packed and all-negative ages.  Then time, in turns on the card,
   each entry beside an empty launch through the same binding (the launch
   floor), the plain version and ``torch.amax`` at n = 1, 2^20 and 2^24,
   and the lane's route from host ages to the send buffer at n_local = 1:
   the old pinned copy + kernel, the by-value launch, and pinned copy +
   ``torch.amax``;
3. digest — hold the checkpoint fingerprint kernel
   (``ops/csrc/chunk_fingerprint.cu``) against its plain PyTorch version
   and the numpy oracle, bit for bit, in every dtype the checkpoint
   fingerprints, at start offsets 0-3 on several chunk grids, one leaf a
   call and every dtype and offset of a size in one batched call; and over
   the flagship's whole save (its 141 train-state leaves, 412,941,316 B)
   in one launch.  Then time it on the card, with the host's enqueue time
   beside, at the flagship's largest leaf (the f32 ``embed``, 65,536,000 B),
   at 1 GiB and over the whole save (the batched launch in turns with the
   141 one-leaf calls), beside the plain version and the bytes bound;
3b. adamw — hold the fused AdamW kernel (``ops/csrc/adamw.cu``) against the
   eager loop it replaced (``adamw_reference``) bit for bit in every
   parameter, ``mu``, ``nu`` and master at GPT-2 XL's full leaf list (387
   leaves, 1,556,764,800 bf16 parameters with an f32 master, at step 4 of
   random state), in one launch.  Then time it on the card in turns, the
   host queued behind a device sleep, beside the eager loop (CUDA events;
   its host enqueue beside), the 28-bytes-a-parameter bound and
   ``torch.optim.AdamW(fused=True)`` over f32 parameters and gradients of
   the same shapes (28 bytes a parameter too), a yardstick only, since it
   orders the arithmetic differently and keeps no master;
4. check — the port's model on the card in f32 against the same model on
   the CPU, at a small size (loss before and after one step);
5. train — the main path: the flagship ``TransformerConfig()`` at full
   width (batch 8 x seq 1024, bf16 with an fp32 master) trained for 3 + 10
   steps in a world of one process over NCCL, each step wrapped by
   ``FusedStepQuorum(identify=True)`` while ``QuorumMonitor(identify=True)``
   ticks from its thread.  The kernel's launch counts are zeroed just
   before and read just after: every fused step and every tick must have
   launched it exactly once, all by value.  The loss must be finite and
   fall, with zero trips;
6. ckpt — the checkpoint path on the same full-width train state (141
   leaves, about 413 MB), both quorum lanes still on, through
   ``AsyncCheckpointer(delta=True, device_digest=True)``.  First one
   256 MiB copy into a registered shm segment must read as pinned and
   return to the host well before the transfer ends.  Then save A with
   three fused steps run while it drains; save A2 of the state those steps
   left (every leaf changed, so every byte transfers); save B with no step
   since A2 (every owned byte skipped); save C after one element of one
   leaf changed (exactly that shard transfers), with three more steps run
   while it drains, on the steady-state path.  Each save launches the
   fingerprint once, over all 141 leaves, and each is restored onto the
   card and compared bit for bit with a device copy taken at its save.  The
   fingerprint's launch count is zeroed just before save A and read just
   after save C;
7. hang — freeze both heartbeats with a 50 ms budget: the monitor must trip
   naming device 0, and the fused lane must trip on the next step;
8. straggler (a) — the same trainer, in the same NCCL world of one, under
   new quorum lanes: ``QuorumMonitor(identify=True, native_beat=True,
   futex_tripwire=True)`` ticks (the pinned C beater of
   ``native/beat_thread.c`` stamps, the futex tripwire watches it) while
   ``FusedStepQuorum(identify=True)`` wraps each step.  The step runs
   through a straggler ``Detector``: ``detection_section("step")`` around
   it, ``wrap_callables`` putting it in an ``OpCollector`` with a native
   shm arena, whose duty cycle (3 s) puts exactly one of 12 steps under
   ``torch.profiler`` with CUDA activity.  Every other step must be
   recorded once, with no drops, each duration (read from the arena's
   shared memory) at least the device time an event pair inside the call
   measured; the profiled step must yield ``xla:`` kernel entries whose
   summed time is at most that step's; the local max must launch once per
   fused step and per tick, by value, with zero trips; and
   ``generate_report()`` gives a one-rank report.  Printed beside the
   card's name and power limit: the native beater's jitter p99 and the
   step time in turns with the detector and collector off and on;
9. hang, native half — freeze the native beater with a 50 ms budget: the
   futex tripwire must trip within budget + 0.2 s and the tick lane must
   trip naming device 0; printed: freeze to trip of both;
10. wrap — the in-process restart ring around the same full-width trainer.
   First an uninterrupted run of 24 steps from the seed-0 state gives the
   reference losses.  Then the port's store server starts on 127.0.0.1 and
   the trainer, rebuilt from the same seed, runs under the port's
   ``Wrapper``: ``initialize`` builds the NCCL world of one, the quorum
   tripwire runs both lanes over it (budget 500 ms), the async
   checkpointer saves the state every 4 steps (committed one step later),
   the health check is ``DeviceProbeHealthCheck`` and the abort ladder is
   ``default_ladder`` with ``AbortCheckpointWorkers`` and
   ``AbortQuorumMonitor`` (then ``AbortTorchDistributed`` and
   ``ClearCudaCaches``).  Three faults, one per iteration: an exception at
   step 6; at step 11 a stall of the main thread in 4 s sleeps with no
   pings, which the monitor process's 3 s soft timeout catches; at step 17
   a frozen quorum heartbeat (beater stopped, no pings, the main thread
   still running bytecode so the soft timeout cannot fire), which the tick
   lane catches.  Each next iteration rebuilds its groups, restores the
   last committed save onto the card (compared bit for bit with a device
   copy taken at the save) and trains on; the last one runs to step 24.
   Every loss of the wrapped run, replayed steps included, must equal the
   reference's bit for bit (deterministic algorithms on).  Printed per
   fault: detection time, the ladder's time per stage, the health probe's
   time, restore time, restart latency (fault to the first finished step
   of the next iteration), steps lost; and the launches of kernels 1 and 2
   in the wrapped run, each fingerprint launch over every leaf of its save;
11. mesh — the dp x tp sharded step (``mesh=``) and its sharded save.
   (a) A world of one over NCCL on a ``("data", "model")`` mesh of (1, 1):
   the unsharded route and the mesh route each train 3 + 10 steps from the
   seed-0 state with deterministic algorithms on, the mesh route under
   ``FusedStepQuorum(identify=True)``; the losses must be equal bit for bit
   and the local max must launch once per fused step.  Then one save of the
   mesh route's state (``DTensor`` leaves) with ``delta=True,
   device_digest=True``, the fingerprint launched once over every owned
   shard and the restore compared bit for bit with a device copy taken at
   the save;
   then both routes' step times, in turns.  (b) Beside local (b) and (c)
   (none of the three claims a time), four processes share the card over gloo on a (2, 2) mesh: each is exec'd as ``python3
   chip_smoke.py --mesh-child <rank> <world> <url>`` (the kernels were built
   above), trains 3 steps from the same seed-0 weights (its box of each)
   and saves once, committed across the four over the port's store server
   run here.  Their losses must be finite, fall, and agree with (a)'s first
   three within 2e-2; the owned shard entries must be the JAX rule's (the
   "data" = 0 ranks own every box of their "model" index, rank 0 the
   replicated leaves, ranks 2 and 3 nothing), each rank that owns shards
   must launch the fingerprint once over them (the others not at all), and
   every rank must restore its boxes
   bit for bit.  A child that fails, or does not finish in 300 s, fails the
   phase.  The gloo times are host-staged collectives on one card, not a
   tensor-parallel speed;
12. straggler (b) — four processes share the card (``python3 chip_smoke.py
   --straggler-child <rank> 4 <store port>``), each training the flagship
   at full width for 8 steps under a ``Detector`` that gathers over the
   port's store server run here.  They step in turns, each while the
   others wait at a store barrier: ranks stepping at once on one card
   share its time slices and move in lockstep.  Rank 3 sleeps 20 ms more in its section
   and runs bf16 matmuls worth about one step's device time inside its
   wrapped call.  Rank 0's report must name rank 3 worst in the section
   and the device scores, give a non-empty ``op_diff(3)``, and
   ``identify_stragglers`` must flag rank 3 and no other (the assertions
   of stage 5 of the JAX package's dryrun, on the card);
13. wedge — a child process (``python3 chip_smoke.py --wedge-child``, exec'd,
   not forked) trains a small model under the port's ``Wrapper`` with the
   monitor process on (soft timeout 3 s, hard 6 s), its 5 steps through an
   ``OpCollector`` whose arena lives in shm, then fires
   ``Fault.DEVICE_HANG``: the spin kernel (``ops/csrc/device_spin.cu``)
   runs on its own stream and the main thread blocks on it in C.  The
   child's exit must be SIGKILL, its log must say ``killing`` and
   ``abort ladder: fingerprint=released``, and the store's interruption
   records must name the soft timeout.  While the child blocks in the spin
   kernel, before the kill, this process reads its op ring by shm name
   (``straggler.inspect.render``) and must find the step's op with a count
   of 5.  Then kernels 1 and 2 are launched
   again and held against their plain versions, to show the card still
   serves.  Printed: spin launch to soft timeout, and to the kill.
14. local — node-local checkpoints and the peer source
   (``checkpointing/local/``, ``async_ckpt/peer_source.py``), run in three
   parts.  (a) In the train phase's NCCL world of one, after the hang
   phase's native half: ``LocalCheckpointManager`` with a
   ``CliqueReplication`` over a ``PeerExchange`` saves the full-width train
   state with ``is_async=True`` while two steps run, then restores it onto
   the card from its resident copy and, after ``drop_resident()``, from
   disk, each bit for bit against a device copy taken at the save and each
   counted under the rung that served it
   (``tpurx_ckpt_restore_source_total``); then ``AsyncCheckpointer(delta=
   True, digest=True, device_digest=True)`` saves g1, one step, g2, the
   ``process_0`` shard files of both are deleted, and
   ``load_checkpoint(g2, peers=...)`` restores onto the card bit for bit
   from a second exchange's ``PeerRestoreSource``, every fetched byte
   served by the first (the fingerprint launched once per save over every
   leaf).
   (b) After mesh (a), beside mesh (b), the port's ``dryrun_multichip(4)``: four gloo
   processes on the card run the five stages of the main path with every
   stage's assertion; kernel 1 must launch once per rank (stage 2) and
   kernel 2 once over each rank's owned shards (stage 3), and rank 0's line
   must carry
   every stage's token.  (c) Four processes (``python3 chip_smoke.py
   --local-child <rank> 4 <url>``, setup in ``CHIP_SMOKE_LOCAL``) share the
   card over gloo, each with its (2, 2) box of the flagship train state
   after one step (``DTensor`` leaves), and save once through
   ``LocalCheckpointManager`` with ``IciReplication`` (factor 2, with a
   ``PeerExchange``); rank 1 loses its node directory and resident copy,
   and all four load: rank 1's blob must come from ``peer_memory``, be
   persisted, and every rank's boxes come back bit for bit.  A child that
   fails, or does not finish in 300 s, fails the phase.  Printed beside
   the card's name and power limit: save, wait and restore ms, blob bytes,
   replicate ms.
15. injob — the in-job restart ring (``tpu_resiliency_torch/
   fault_tolerance/``), run after the wrap phase: the port's launcher CLI
   (``python -m tpu_resiliency_torch.fault_tolerance.launcher --host-store
   --max-restarts 3``) with its rendezvous, its per-rank monitor processes
   and its pre-join CUDA probe (``health/device.py``, on), around the
   trainer worker ``tests/workloads/torch_ft_worker.py`` (rank-monitor
   heartbeats, the progress file, both quorum lanes with the tick lane's
   ``on_stale`` asking the launcher for a restart, ``AsyncCheckpointer(
   delta=True, device_digest=True)`` every 4 steps, resume from the newest
   committed save, deterministic algorithms).  (a) The flagship at full
   width in an NCCL world of one: 24 steps uninterrupted, then the same
   through three faults, one per cycle — the worker SIGKILLs itself at step
   6; stops heartbeating at step 11 (the monitor's 5 s heartbeat timeout
   kills it); stops its quorum beats at step 17 while heartbeating (budget
   500 ms: the tick lane must request the restart well before the heartbeat
   timeout).  Every loss must equal the uninterrupted run's bit for bit,
   at most 4 steps lost per fault, kernels 1 and 2 launched in the workers,
   kernel 2 once per save over the rank's owned leaves.
   (b) A launcher whose environment has ``CUDA_VISIBLE_DEVICES=""``: the
   probe must refuse the node (``UnhealthyNodeError``, nonzero exit) and no
   worker may start; it touches no card and runs beside (a)'s uninterrupted
   run.  (c) Two workers share the card over gloo on a (2, 1) ``("data",
   "model")`` mesh at the tiny config, the probe off; rank 1 crashes at
   step 3 of cycle 0, both restart, and their losses must equal an
   uninterrupted two-worker run's bit for bit.  (a)'s uninterrupted run
   with (b), then (c), run beside (a)'s faulted run.  Printed beside the
   card's name and power
   limit: detection and restart latency per fault (from the launcher's
   profiling events), steps lost, spawn to first step per cycle (CUDA
   init, process group, restore), the probe's time, stats and cache flag,
   and the workers' kernel launches per cycle.  The phase is bounded at
   300 s, each launcher run by its own timeout.
16. control — the job-level control plane (``python -m tpu_resiliency_torch.
   fault_tolerance.control_plane``), the store's sharded, multiplexed and
   failover clients and the rank monitor's passive health loop, run after
   the injob phase, (c) beside (a) and then (b).  (a) The control plane with a
   journal and one launcher without ``--host-store`` around the flagship
   worker, which reaches the store through ``store_from_env`` with
   ``TPURX_STORE_MUX=1`` and commits its saves over it; the probe on, the
   health loop on (1 s; ``node_resources,nic_link,tpu_sys,kernel_log,
   counter_window,node_daemon``, the kernel log a file of the phase's).  The
   worker SIGKILLs itself at step 6 of cycle 0; in cycle 1, once the
   progress file reads 12 (the save of step 12 draining), the control plane
   is SIGKILLed and restarted from its journal on the same port 2 s later.
   As in the JAX package the restarted control plane opens the next round,
   so the launcher rides out the outage and restarts the worker from its
   last save in cycle 2.  Every loss must equal the injob phase's
   uninterrupted run's bit for bit, at most 4 steps lost to the crash and
   4 + 1 to the outage's restart (the worker waits out the outage in the
   commit of the save it reached, and the step that save preceded is lost
   when the new round stops it before the commit lands), cycle
   numbering continued (no round 0 after the restart), every save
   committed once (the commit counters read back from the control plane's
   store), zero health failures and zero quorum trips, and ``tpu_sys``
   counting the host's cards in a process without torch.  (b) The port's
   ``Wrapper`` with ``store_factory=store_from_env`` over ``--shards 3
   --spares 1`` (``TPURX_STORE_SHARDS``) trains the flagship for 16 steps:
   before step 7 the shard of the ring's interruption log is SIGKILLed and
   the control plane promotes the spare (epoch 1); an exception at step 10
   restarts the ring over the promoted map.  No routed op may raise, and
   every loss must equal the wrap phase's reference bit for bit.  (c) Three
   launchers (A, B, and C as the hot spare) at the tiny config over gloo,
   after an uninterrupted two-node run (each run its own control plane),
   each with the health loop on its own kernel-log file: an Xid 43 line on
   A's must exclude nothing, an Xid 79 line on B's must exclude B and C
   must finish the job, its losses equal to an uninterrupted two-node run's
   bit for bit.  Printed beside the card's name and power limit: the
   crash's detection and restart, the outage's ride-out (kill to the first
   store op served), the longest worker store op, spawn to first step per
   cycle, the probe, the health loop's runs and verdicts, what the passive
   checks read on this host, kill to epoch bump, the longest routed op,
   Xid to ``health_failure`` and exclusion to the spare's first step, and
   the workers' kernel launches (kernel 2 once per save over the worker's
   owned leaves).  The phase is bounded at 240 s.
17. policy — the adaptive policy loop (``tpu_resiliency_torch/policy/``, the
   rest of ``telemetry/``, the knob runtime overrides) and the lock-order
   sanitizer, run after the control phase.  (a) Wrap's trainer at full
   width under the port's ``Wrapper`` (a world of one over NCCL, both quorum
   lanes) with ``TPURX_POLICY=1``, ``TPURX_METRICS_PORT`` and
   ``TPURX_CLOCK_CAL=1``, and a standalone ``PolicyController`` over its
   ``TelemetryFeed`` ticked every second beside it (journal keep 2): saves
   are gated by a ``SaveScheduler`` that reads ``TPURX_CKPT_INTERVAL_S`` at
   each step, starting from 60 s; an exception fires 15 steps into each of
   the first three iterations, 45 steps in all.  The run must return after
   every fault with every loss equal to an uninterrupted run's bit for bit
   (whose first steps are wrap's); ``/metrics``, scraped at the first
   decision after the first fault, must parse as OpenMetrics, hold every
   ``tpurx_policy_*`` family and a ``tpurx_policy_mtbf_s`` measured from
   the fault rate; every cadence action must equal Young/Daly of the
   estimator snapshot it came from (clamped), and each later save decision
   must use it; kernel 2 must launch once per save over all 141 leaves;
   the store must keep only the last two ``policy/journal/<seq>`` keys;
   every flight dump must carry a clock offset (this rank-0 process
   calibrates against the reference the wrapper serves) and
   ``trace.convert`` must render each episode.  Then 12 steps with ``TPURX_SHRINK_MESH=1`` and one exception:
   the shrink stage releases, the episode is labelled ``mesh_shrink`` in the
   rung ledger, and the run restores bit for bit.  (b) Predict-and-evacuate:
   three processes (``python3 chip_smoke.py --evac-child <rank> 3 <url>``,
   setup in ``CHIP_SMOKE_EVAC``) share the card over gloo, each training the
   flagship with a ``LocalCheckpointManager`` under ``CliqueReplication``
   (factor 2) over the port's store server, a ``CrossRankAggregator`` round
   every step; rank 0 hosts a ``PolicyController`` over
   ``SnapshotFeed(read_latest_snapshots)`` with ``TPURX_EVAC=1``, ranks 1
   and 2 poll a ``PolicyClient``.  Rank 1's health and straggler scores ramp
   over 12 steps and it hard-faults at step 30 unless evacuated.  Every
   rank runs its side of the ``EvacuationPipeline``: a checkpoint-ahead
   save (the victim's also through ``AsyncCheckpointer(delta=True,
   device_digest=True)``, one fingerprint launch over its 141 leaves) and
   the victim-scoped ladder (``evacuation_ladder``, on the victim alone);
   two steps later the victim drops its resident copy and node directory
   and warm-joins from its peers' memory.  The victim must be evacuated once, before the
   deadline, no healthy rank at all, the ``evac/`` records published, the
   join warm (peer-memory bytes > 0, none from disk) and bit for bit, and
   each published decision batch applied once by each client.  (c) Beside
   (b) (neither claims a time), two processes (``--sanitize-child``) run the
   ``Wrapper`` over gloo on the
   card at the flagship's width and 2 layers for 8 steps under
   ``TPURX_SANITIZE=1`` with a witness path; rank 1 raises at step 3 of
   iteration 0.  Both must exit 0 with ``ret=done@1``, the witness files
   must hold edges and no cycle, and ``python -m tpurx_lint --witness``
   must read them.  Printed beside the card's name and power limit: (a)'s
   faults, restarts, cadence actions and saves, (b)'s per-stage
   ``tpurx_evac_stage_ns``, checkpoint-ahead launches and join, (c)'s
   witness counts.
18. attrib — the attribution plane (``tpu_resiliency_torch/attribution/``,
   ``services/``, ``integrations/``, ``utils/memory.py``,
   ``checkpointing/dcp_compat.py``) behind the in-job ring's restart gate,
   run after the policy phase.  (a) The port's launcher around the flagship
   worker (as in the injob phase: the probe on, both quorum lanes, delta
   saves with the device fingerprint) with the attribution gate on,
   ``attribution_service_mode=spawn`` (the launcher spawns ``python -m
   tpu_resiliency_torch.services.attrsvc`` and publishes its endpoint),
   per-cycle logs and a cycle-info directory; the worker runs its loop
   through ``CallbackRunner`` with a ``FaultToleranceCallback`` and a
   ``DeviceMemoryLogger`` (``FT_CALLBACKS=1``).  Cycle 0 SIGKILLs itself at
   step 6: the gate must consult the spawned service (never the inline
   fallback) and allow the restart with resume true.  Cycle 1 resumes from
   the last committed save, loads the timeouts cycle 0 learned, and at
   step 6 allocates until its allocated bytes cross the logger's warning
   fraction (half of what ``torch.cuda.mem_get_info`` leaves free after this
   process empties its cache) and then the card's whole memory, more than
   is free: torch raises its ``OutOfMemoryError``.  The gate must return ``oom_hbm``, resume false,
   confidence >= 0.8, culprit ranks [0], and the launcher must stop non-zero
   with no cycle 2.  Every loss must equal the injob phase's uninterrupted
   run's bit for bit, and kernels 1 and 2 must launch in the workers,
   kernel 2 once per save over the worker's leaves.
   (b) The port's attrsvc and smonsvc as processes over (a)'s directories:
   ``/status`` and ``/jobs`` must show the two ended cycles, both failed,
   with the attrsvc's verdicts (cycle 1 ``oom_hbm``), and the job RUNNING:
   smonsvc marks a job whose last cycle failed FAILED only once its idle
   threshold (600 s, no CLI flag) has passed, which a ``JobMonitor`` over
   the same directories with a threshold of 0 must show; ``POST /submit`` of
   cycle 1's log with its progress marker must give a combined ``oom_hbm``
   with resume false; ``python -m tpu_resiliency_torch.attribution.
   mcp_server`` over stdio must answer ``initialize``, ``tools/list`` and
   ``analyze_log`` on that log with ``oom_hbm``.  (c) The flagship's train
   state (141 leaves, 412,941,316 B, one step from the seed-0 weights)
   saved with ``DcpCompatCheckpointer.save``, loaded in place onto the card
   with ``load_dcp_checkpoint`` and migrated with ``migrate_to_tpurx``
   under ``TPURX_CKPT_DEVICE_DIGEST=1`` (one fingerprint launch over the
   141 leaves), each restore bit for bit.  Printed beside the card's name
   and power limit: the gate's verdicts and ms, spawn to first step, the
   smonsvc status, the save, load and migration ms.  The phase is bounded at 180 s.
19. examples — the port's examples (``examples/torch/``), after every other
   phase, beside the soak's (a)-(d), each a process of its own with its
   default device (the card; ``advanced_example.py``, ``async_ckpt.py`` and
   ``straggler/example.py``, which claim no time, side by side),
   run as ``python3 chip_smoke.py --example-run <script> [args]``, which
   runs the script as ``__main__`` and then writes the launch counts of
   kernels 1 and 2 and its saves.  ``inprocess/advanced_example.py`` over
   the port's store server, a world of one over NCCL: its quorum tripwire's
   tick lane must launch kernel 1.  ``inprocess_restart.py`` as two ranks
   sharing the card over the store server: rank 1 is SIGKILLed once both
   run iteration 0, and rank 0 must re-enter as a world of one and finish.
   ``checkpointing/async_ckpt.py`` under ``TPURX_CKPT_DEVICE_DIGEST=1``: its
   four saves (three, then a delta save of the unchanged state) must
   launch kernel 2 once each, the delta save must write 0 bytes and copy
   none of the state from the card, and its checkpoints must restore here
   bit for bit against the state drawn from the same seed.
   ``straggler/example.py``: 16 samples in the always-on collector.
   ``train_with_launcher.py`` under the port's launcher at the flagship's
   full width (one worker, batch 8 x 1024), ``TPURX_CKPT_DEVICE_DIGEST=1``,
   rank 0 SIGKILLed 10 s into cycle 0: cycle 1 must resume from the latest
   step committed at the kill (a thread samples the progress file and the
   committed checkpoints every 2 ms), lose at most the save interval of 20
   steps and finish every step, with kernel 2 launched once per save of
   cycle 1.  Each run prints its exit code, wall seconds, sentinel line and
   launches; the phase is bounded at 180 s.
20. soak — the port's chaos soak: five campaigns of ``python -m
   tpu_resiliency_torch.soak``, each in a session of its own with its
   workers on the card and its temporary files under the phase's
   directory.  (a)-(d) start just before the examples phase and run beside
   it: (a) the gate's mix for 120 s, ``--chaos-store --quorum
   --store-kill-mid-save`` with the JAX smoke's probabilities and bounds
   (15000 / 60000 ms), (b) ``--corrupt-blob bitflip`` with its trees on
   the card, (c) ``--link-degrade`` and (d) ``--store-longpoll-abort``.
   Once the examples and (b)-(d) have ended, (e) ``--fault-shift`` at 40 s
   an arm (a worker's start on the card takes 8-17 s) runs beside the rest
   of (a).  (a)'s report must hold ``ok``, monotone progress and the
   ladder, at least one store kill, one inner recovery and one
   ``fingerprint/released``, a restart cycle for the crashes and hangs
   injected, every started save completed, kernel 1 launched in the
   workers' tick lanes (each worker writes its count per step) and every
   worker on the card; each other campaign must meet its JAX smoke test's
   assertions ((e): both arms ok, a finite gain, and progress > 0 in each
   arm as the arm reported it; the 1.1x gate is printed).  Afterwards no
   process of these campaigns may be left, on the card (``nvidia-smi``) or
   off it.  Each report is printed; the phase is bounded at 300 s.

A line ``timeline: <phases> ended at <s> s`` follows each phase.

Informational lines come first; the line before the last holds the card's
name and power limit, and the last line is one JSON object
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA card,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and the
# non-tensor-core f32 rate, used for the int32 compares of the local max
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

KERNEL_SIZES = (1, 8, 31, 32, 33, 1000, 1024, 1025, 65536, 1 << 20,
                (1 << 20) + 3, 1 << 24)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 3, 10
HANG_BUDGET_MS = 50.0
DIGEST_DTYPES = ("float32", "bfloat16", "float16", "float64", "int8", "uint8",
                 "int32", "int64", "bool")
# (elements, chunk grids): the plain version loops over chunks in Python,
# so the finest grid is kept to the smaller sizes
DIGEST_CASES = (
    (1, ((1024, False), (4096, True), (16 << 20, True))),
    (1000, ((1024, False), (4096, True), (16 << 20, True))),
    (4097, ((1024, False), (4096, True), (16 << 20, True))),
    ((1 << 20) + 3, ((65536, True), (16 << 20, True))),
    ((1 << 23) + 1, ((1 << 20, False), (16 << 20, True))),
)
EMBED_F32_ELEMS = 32000 * 512  # the flagship's largest leaf: f32 embed
DRAIN_STEPS = 3
SAVES = ("A", "A2", "B", "C")
# saves with fused steps run while they drain: A on fresh shm, C in the
# steady state (no save follows C, so its steps change nothing checked)
DRAIN_STEP_SAVES = ("A", "C")
# wrap phase: the fault schedule, iteration -> (kind, step it fires before)
WRAP_STEPS = 24
WRAP_SAVE_EVERY = 4
WRAP_FAULTS = {0: ("exception", 6), 1: ("stall", 11), 2: ("quorum_freeze", 17)}
WRAP_SOFT_TIMEOUT_S = 3.0
WRAP_STALL_SLEEP_S = 4.0      # one C-level sleep of the stall: > soft timeout
WRAP_QUORUM_BUDGET_MS = 500.0
# mesh phase: (b)'s mesh of four gloo processes on the one card, the steps
# each trains, and how far its losses may sit from (a)'s first ones.  (b)
# splits each bf16 matmul of the step over two "model" ranks and sums the
# halves after each is rounded to bf16 (one more rounding, 2^-9 relative,
# per summed activation), and averages the loss over two "data" ranks; the
# loss of the random-init flagship is about 10.4, so these move it in its
# third or fourth digit, and 2e-2 (0.2% of it) bounds that with room
MESH_SHAPE = (2, 2)
MESH_STEPS = 3
MESH_LOSS_TOL = 2e-2
MESH_CHILD_TIMEOUT_S = 300.0
MESH_TIME_ROUNDS, MESH_TIME_STEPS = 6, 5
# wedge phase: the child's monitor-process timeouts
WEDGE_SOFT_TIMEOUT_S = 3.0
WEDGE_HARD_TIMEOUT_S = 6.0
WEDGE_OPRING_KEY = "chip_smoke/wedge/opring"  # the child's op-ring shm name
# straggler phase: (a) the steps through the Detector, the collector's
# duty-cycle interval (one step, the first after it, runs under the
# profiler) and the timing turns; (b) four processes on the card, 8 steps
# each in turns, rank 3 slow by 20 ms in its section and by about one step
# of bf16 matmuls in its wrapped call
STRAGGLER_STEPS = 12
STRAGGLER_PROFILE_INTERVAL_S = 3.0
STRAGGLER_TIME_ROUNDS, STRAGGLER_TIME_STEPS = 6, 5
STRAGGLER_WORLD, STRAGGLER_SLOW_RANK, STRAGGLER_CHILD_STEPS = 4, 3, 8
STRAGGLER_SLOW_SLEEP_S = 0.02
STRAGGLER_WARM_S = 0.5
STRAGGLER_CHILD_TIMEOUT_S = 300.0
# local phase: (a) the steps run while a local save writes; (b) and (c) four
# processes on the card, (c) with rank 1's node lost; a child that does not
# finish within the bound fails the phase
LOCAL_DRAIN_STEPS = 2
LOCAL_WORLD, LOCAL_LOST_RANK = 4, 1
LOCAL_CHILD_TIMEOUT_S = 300.0


def _beside(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` in a thread beside the caller's work; the
    returned callable waits for it and returns its result or raises what it
    raised.  Only for sub-phases that claim no time (their walls are then
    taken beside each other)."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 - re-raised by result()
            box["exc"] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    return result


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, torch) -> float:
    """Mean ms per call of ``fn`` on the card, by CUDA events around
    ``iters`` calls after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns: dict, iters: int, rounds: int, torch) -> dict:
    """Median ms per call of each of ``fns``, timed in turns on one card:
    forward then backward order (kernel, amax, amax, kernel), ``rounds``
    times."""
    names = list(fns)
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            samples[name].append(time_ms(fns[name], iters, torch))
    return {name: sorted(v)[len(v) // 2] for name, v in samples.items()}


def local_max_bound_ms(n: int) -> tuple:
    """Least time for the local max of n int32: read 4n bytes, write 4, and
    n - 1 compares."""
    by_bytes = (4 * n + 4) / HBM_BYTES_PER_S * 1e3
    by_ops = max(n - 1, 0) / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """Matmul FLOPs of one train step from the shapes: forward per token
    2(4d^2 + 2df) + 4Td per layer (projections, MLP, QK^T and PV over the
    full T x T) and 2dV for the tied logits; backward twice the forward."""
    d, f, T = cfg.d_model, cfg.d_ff, seq
    per_token = cfg.n_layers * (8 * d * d + 4 * d * f + 4 * T * d) + 2 * d * cfg.vocab
    return 3 * batch * seq * per_token


def _ages(np, rng, kind: str, n: int, q):
    if kind == "random":
        return rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
    if kind == "packed":
        return q.pack_age_device(rng.integers(0, 2 ** 17, size=n),
                                 rng.integers(0, 1 << 16, size=n))
    return rng.integers(-2 ** 31, 0, size=n, dtype=np.int64).astype(np.int32)


def _at_offset(torch, values, offset: int, dev):
    """``values`` on the card as a contiguous view ``offset`` int32 elements
    past a 16-byte boundary."""
    base = torch.empty(values.size + 8, dtype=torch.int32, device=dev)
    lead = (-(base.data_ptr() >> 2)) % 4
    x = base[lead + offset:lead + offset + values.size]
    x.copy_(torch.from_numpy(values))
    return x


def kernel_phase(torch, np, q) -> dict:
    """Both entries against their plain versions at every size and offset;
    times in turns at n = 1 (the path's shape), 2^20 and 2^24, and the
    lane's route at n_local = 1."""
    dev = torch.device("cuda", torch.cuda.current_device())
    index = dev.index
    rng = np.random.default_rng(0)
    worst = 0
    out = torch.empty(1, dtype=torch.int32, device=dev)
    for n in KERNEL_SIZES:
        for kind in ("random", "packed", "negative"):
            values = _ages(np, rng, kind, n, q)
            want_np = int(values.max())
            checks = []
            for offset in range(4):
                x = _at_offset(torch, values, offset, dev)
                checks.append((f"pointer entry, offset {offset}",
                               q.local_max(x), q.local_max_reference(x)))
            if n <= q.BY_VALUE_MAX:
                checks.append(("by-value entry",
                               q.local_max_host(values, torch.empty_like(out)),
                               q.local_max_host_reference(values)))
            torch.cuda.synchronize()
            for what, got, want in checks:
                err = abs(int(got[0]) - int(want[0]))
                if err != 0 or int(got[0]) != want_np:
                    raise AssertionError(
                        f"local max {what} disagrees at n={n} ({kind}): kernel "
                        f"{int(got[0])}, plain {int(want[0])}, numpy {want_np}"
                    )
                worst = max(worst, err)
    print(f"kernel phase: quorum local max equals the plain version and numpy "
          f"at n in {list(KERNEL_SIZES)}: pointer entry at offsets 0-3, "
          f"by-value entry at n <= {q.BY_VALUE_MAX} (random, packed and "
          f"all-negative ages)")

    empty = q._kernel("tpurx_empty_launch")

    def floor():
        if empty(index, q._raw_stream(index)) != 0:
            raise RuntimeError("empty launch failed")

    timings = {}
    for n, iters in ((1, 2000), (1 << 20, 200), (1 << 24, 50)):
        values = rng.integers(0, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
        x = torch.from_numpy(values).to(dev)
        fns = {"ms": lambda: q.local_max(x, out),
               "library_ms": lambda: torch.amax(x),
               "plain_ms": lambda: q.local_max_reference(x)}
        if n == 1:
            fns["by_value_ms"] = lambda: q.local_max_host(values, out)
            fns["launch_floor_ms"] = floor
        rec = time_in_turns(fns, iters, 4, torch)
        rec["bound_ms"], rec["bound_by"] = local_max_bound_ms(n)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        timings[n] = rec
        extra = (f", by value {rec['by_value_ms'] * 1e3:.2f} us, empty launch "
                 f"{rec['launch_floor_ms'] * 1e3:.2f} us" if n == 1 else "")
        print(f"kernel phase: n={n}: kernel {rec['ms'] * 1e3:.2f} us, "
              f"plain {rec['plain_ms'] * 1e3:.2f} us, torch.amax "
              f"{rec['library_ms'] * 1e3:.2f} us{extra}, bound "
              f"{rec['bound_ms'] * 1e3:.6f} us ({rec['bound_by']}, "
              f"{100 * rec['bound_share']:.1f}% of it)")

    ages = q.pack_age_device(np.array([1234]), np.array([0]))
    host = torch.from_numpy(ages)
    lane = time_in_turns({
        "old_ms": lambda: q.local_max(
            host.pin_memory().to(dev, non_blocking=True), out),
        "new_ms": lambda: q.local_max_host(ages, out),
        "library_ms": lambda: torch.amax(
            host.pin_memory().to(dev, non_blocking=True)),
    }, 1000, 4, torch)
    print(f"kernel phase: lane route at n_local=1 (host ages to send buffer): "
          f"pinned copy + kernel {lane['old_ms'] * 1e3:.2f} us, by value "
          f"{lane['new_ms'] * 1e3:.2f} us, pinned copy + torch.amax "
          f"{lane['library_ms'] * 1e3:.2f} us")
    t1, t24 = timings[1], timings[1 << 24]
    for claim, met in (
        ("n=1 tensor entry no slower than torch.amax", t1["ms"] <= t1["library_ms"]),
        ("by-value lane route no slower than pinned copy + kernel",
         lane["new_ms"] <= lane["old_ms"]),
        ("n=2^24 at least 50% of the bytes bound", t24["bound_share"] >= 0.5),
        ("n=2^24 no slower than torch.amax", t24["ms"] <= t24["library_ms"]),
        ("n=2^20 no slower than torch.amax",
         timings[1 << 20]["ms"] <= timings[1 << 20]["library_ms"]),
    ):
        print(f"kernel phase: {claim}: {'met' if met else 'NOT met'}")
    return {"max_abs_err": worst, "timings": timings, "lane": lane}


def fp_counts(dd) -> dict:
    """Kernel 2's counters: its launches and the shards they covered."""
    return {"chunk_fingerprint": dd.batch_fingerprints.launches,
            "chunk_fingerprint_shards": dd.batch_fingerprints.shards}


def fingerprint_bound_ms(nbytes: int, lane_bytes: int, n_chunks: int) -> tuple:
    """Least time for the fingerprint of ``nbytes``: read them once and
    write 8 bytes per chunk, or 14 integer operations per lane (mix 11,
    two adds, one multiply) at the scalar rate, whichever is larger."""
    by_bytes = (nbytes + 8 * n_chunks) / HBM_BYTES_PER_S * 1e3
    by_ops = 14 * (nbytes // lane_bytes) / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_and_host_ms(fn, iters: int, torch, what: str = "") -> tuple:
    """(device ms, host ms) per call of ``fn``: the host's enqueue time by
    its clock, and the device time by CUDA events around ``iters`` calls
    queued behind a device sleep long enough that the host has enqueued
    every call before the first one runs, so the card never waits for the
    host.  Raises when the host did not get ahead of the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for sleep_s in (2 * host_s * iters + 1e-3, 8 * host_s * iters + 5e-3):
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles at up to 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters, host_s * 1e3
    raise AssertionError(f"the host did not enqueue {iters} calls of {what} "
                         f"ahead of the card")


def device_and_host_in_turns(fns: dict, iters: dict, rounds: int, torch) -> dict:
    """Median device and host ms per call of each of ``fns``
    (:func:`device_and_host_ms`), in turns: forward then backward order,
    ``rounds`` times.  Keys ``<name>`` (device) and ``<name>_host``."""
    names = list(fns)
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            samples[name].append(device_and_host_ms(fns[name], iters[name], torch,
                                                    name))
    out = {}
    for name, v in samples.items():
        out[name] = sorted(d for d, _ in v)[len(v) // 2]
        out[f"{name}_host"] = sorted(h for _, h in v)[len(v) // 2]
    return out


def _digest_oracle(torch, np, dd, x, chunk_bytes: int, direct: bool):
    """The numpy oracle's rows of ``x``'s bytes."""
    widths = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
    raw = x.cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
    return dd.host_fingerprints(raw, widths[x.element_size()], chunk_bytes, direct)


def _flagship_state(torch, tr, dev) -> list:
    """The flagship's 141 train-state leaves on the card from the seed-0
    weights, with random ``mu`` and ``nu`` and a step count of 3."""
    params = tr.init_params(tr.TransformerConfig(), torch.Generator(dev).manual_seed(0),
                            device=dev)
    opt = tr.init_opt_state(params)
    g = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        for t in opt["mu"] + opt["nu"]:
            t.normal_(generator=g)
        opt["count"] += 3
    from tpu_resiliency_torch.utils.tree import leaves

    return leaves(tr.state_tree(params, opt))


def digest_phase(torch, np, dd, tr, dev) -> dict:
    """The fingerprint kernel against its plain version and the numpy
    oracle, bit for bit, leaf by leaf and batched; device and host times in
    turns at the embed leaf, at 1 GiB and over the flagship's whole save
    (one batched launch against 141 one-leaf calls)."""
    rng = np.random.default_rng(0)
    checked = mismatched = worst = 0
    batched = 0

    def compare(got, x, chunk_bytes, direct, label):
        nonlocal checked, mismatched, worst
        want = dd.fingerprint_reference(x, chunk_bytes, direct).cpu().numpy().view(np.uint32)
        oracle = _digest_oracle(torch, np, dd, x, chunk_bytes, direct)
        g = got.cpu().numpy().view(np.uint32).astype(np.int64)
        for ref in (want, oracle):
            if g.size:
                worst = max(worst, int(np.abs(g - ref).max()))
        if not (np.array_equal(g, want) and np.array_equal(g, oracle)):
            mismatched += 1
            print(f"digest phase: MISMATCH {label}")
        checked += 1

    for n, grids in DIGEST_CASES:
        xs = []
        for name in DIGEST_DTYPES:
            host = (rng.standard_normal(n + 4) * 100).astype(np.float32)
            base = torch.from_numpy(host).to(getattr(torch, name)).to(dev)
            xs.extend((name, offset, base[offset:offset + n]) for offset in range(4))
        for chunk_bytes, direct in grids:
            singles = []
            for name, offset, x in xs:
                singles.append(dd.shard_fingerprints(x, chunk_bytes, direct))
                compare(singles[-1], x, chunk_bytes, direct, f"{name} n={n} "
                        f"offset={offset} grid=({chunk_bytes}, {direct})")
            # every dtype and offset of this size in one batched call, against
            # the one-leaf calls just held to the plain version and numpy
            rows = dd.batch_fingerprints([x for _, _, x in xs], chunk_bytes, direct)
            for (name, offset, _), got, one in zip(xs, rows, singles):
                if not torch.equal(got, one):
                    mismatched += 1
                    print(f"digest phase: MISMATCH batched {name} n={n} "
                          f"offset={offset} grid=({chunk_bytes}, {direct})")
                batched += 1
    chunk_bytes = dd.default_chunk_bytes()
    state = _flagship_state(torch, tr, dev)
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    launches0 = (dd.batch_fingerprints.launches, dd.batch_fingerprints.shards)
    rows = dd.batch_fingerprints(state, chunk_bytes, True)
    save_counts = (dd.batch_fingerprints.launches - launches0[0],
                   dd.batch_fingerprints.shards - launches0[1])
    for k, (x, got) in enumerate(zip(state, rows)):
        compare(got, x, chunk_bytes, True, f"flagship leaf {k} {x.dtype} "
                f"{tuple(x.shape)}")
    if mismatched:
        raise AssertionError(f"fingerprint kernel disagrees in {mismatched} of "
                             f"{checked} cases")
    if save_counts != (1, len(state)):
        raise AssertionError(f"the whole save took {save_counts} (launches, "
                             f"shards), not (1, {len(state)})")
    print(f"digest phase: chunk fingerprint equals the plain version and numpy "
          f"bit for bit in {checked} cases: {list(DIGEST_DTYPES)}, "
          f"n in {[n for n, _ in DIGEST_CASES]}, offsets 0-3, chunk grids "
          f"1 KiB to 16 MiB, direct and buffered, one leaf a call (and the "
          f"same {batched} batched, equal to them); and the flagship's "
          f"{len(state)} state leaves ({state_bytes} B) in one launch")

    card = card_line()
    timings = {}
    for label, n, iters, plain_iters in (("embed", EMBED_F32_ELEMS, 100, 5),
                                         ("1GiB", 1 << 28, 20, 2)):
        x = torch.randn(n, device=dev)
        nbytes = n * 4
        n_chunks = len(dd.chunk_grid(nbytes, chunk_bytes, True))
        rec = device_and_host_in_turns({"ms": lambda: dd.shard_fingerprints(x)},
                                       {"ms": iters}, 4, torch)
        rec.update(time_in_turns(
            {"plain_ms": lambda: dd.fingerprint_reference(x, chunk_bytes, True)},
            plain_iters, 2, torch))
        rec["bound_ms"], rec["bound_by"] = fingerprint_bound_ms(nbytes, 4, n_chunks)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["nbytes"] = nbytes
        timings[label] = rec
        print(f"digest phase: {label} ({nbytes} B f32, {n_chunks} chunks): kernel "
              f"{rec['ms'] * 1e3:.2f} us on the card ({rec['ms_host'] * 1e3:.2f} us "
              f"of host enqueue), plain {rec['plain_ms'] * 1e3:.2f} us, bound "
              f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}, "
              f"{100 * rec['bound_share']:.1f}% of it); no single PyTorch call "
              f"computes it ({card})")
        del x

    # the whole save: one batched launch against the 141 one-leaf calls
    rec = device_and_host_in_turns(
        {"batched_ms": lambda: dd.batch_fingerprints(state, chunk_bytes, True),
         "per_leaf_ms": lambda: [dd.shard_fingerprints(t, chunk_bytes, True)
                                 for t in state]},
        {"batched_ms": 10, "per_leaf_ms": 1}, 4, torch)
    rec.update(time_in_turns(
        {"plain_ms": lambda: [dd.fingerprint_reference(t, chunk_bytes, True)
                              for t in state]}, 2, 2, torch))
    n_rows = 0
    rec["bound_ms"] = 0.0
    for t in state:
        nbytes = t.numel() * t.element_size()
        n_chunks = len(dd.chunk_grid(nbytes, chunk_bytes, True))
        n_rows += n_chunks
        bound, by = fingerprint_bound_ms(nbytes, dd.lane_bytes(t.element_size()),
                                         n_chunks)
        rec["bound_ms"] += bound
        if by != "bytes":
            raise AssertionError(f"leaf {tuple(t.shape)} {t.dtype} is bound by {by}")
    rec["bound_by"] = "bytes"
    rec.update(nbytes=state_bytes, leaves=len(state), chunks=n_rows,
               bound_share=rec["bound_ms"] / rec["batched_ms"],
               per_leaf_bound_share=rec["bound_ms"] / rec["per_leaf_ms"])
    timings["save"] = rec
    print(f"digest phase: the flagship's whole save ({len(state)} leaves, "
          f"{state_bytes} B, {n_rows} chunks): one batched launch "
          f"{rec['batched_ms'] * 1e3:.2f} us on the card, "
          f"{rec['batched_ms_host'] * 1e3:.2f} us of host enqueue, "
          f"{100 * rec['bound_share']:.1f}% of the {rec['bound_ms'] * 1e3:.2f} us "
          f"bound (bytes); 141 one-leaf calls {rec['per_leaf_ms'] * 1e3:.2f} us on "
          f"the card, {rec['per_leaf_ms_host'] * 1e3:.2f} us of host enqueue, "
          f"{100 * rec['per_leaf_bound_share']:.1f}% of it; plain "
          f"{rec['plain_ms'] * 1e3:.2f} us ({card})")
    del state, rows
    return {"checked": checked, "batched": batched, "timings": timings,
            "max_abs_err": worst}


ADAMW_HYPER = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.01)


def adamw_phase(torch, tr, adamw, dev) -> dict:
    """Kernel 4 against the eager loop at GPT-2 XL's leaf list (the
    benchmark's ``gpt2-xl`` configuration), bit for bit and in one launch;
    its time in turns beside the loop, the bound and
    ``torch.optim.AdamW(fused=True)``."""
    from portbench import adamw_counts, spec

    xl = spec.config({"file": "portbench/configs/gpt2-xl.json"})["model"]
    cfg = tr.TransformerConfig(**xl, dtype=torch.bfloat16)
    model = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    opt = tr.init_opt_state(model)
    ps = [p.detach() for p in model.parameters()]
    n_params = sum(p.numel() for p in ps)
    if n_params != adamw_counts.model_params(xl):
        raise AssertionError(f"GPT-2 XL has {n_params} parameters, the benchmark "
                             f"counts {adamw_counts.model_params(xl)}")
    g = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        for t in opt["mu"]:
            t.normal_(0.0, 1e-3, generator=g)
        for t in opt["nu"]:
            t.normal_(0.0, 1e-6, generator=g).abs_()
        grads = [(torch.randn(p.shape, generator=g, device=dev) * 1e-3).to(p.dtype)
                 for p in ps]
    count = torch.full((), 4, dtype=torch.int32, device=dev)
    cf = count.to(torch.float32)
    bc1, bc2 = 1 - ADAMW_HYPER["b1"] ** cf, 1 - ADAMW_HYPER["b2"] ** cf
    fused = (ps, opt["mu"], opt["nu"], opt["master"])
    plain = tuple([t.clone() for t in ts] for ts in fused)
    table = adamw.LeafTable()

    def kernel():
        adamw.fused_adamw(fused[0], grads, *fused[1:], bc1, bc2, **ADAMW_HYPER,
                          table=table)

    def loop():
        adamw.adamw_reference(plain[0], grads, *plain[1:], bc1, bc2, **ADAMW_HYPER)

    before = (adamw.fused_adamw.launches, adamw.fused_adamw.leaves)
    kernel()
    launched = (adamw.fused_adamw.launches - before[0],
                adamw.fused_adamw.leaves - before[1])
    loop()
    torch.cuda.synchronize()
    differ, max_abs_err = [], 0.0
    for what, a_list, b_list in zip(("param", "mu", "nu", "master"), fused, plain):
        for k, (a, b) in enumerate(zip(a_list, b_list)):
            ia = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
            ib = b.view(torch.int16 if b.element_size() == 2 else torch.int32)
            if not torch.equal(ia, ib):
                differ.append((what, k, int((ia != ib).sum())))
            max_abs_err = max(max_abs_err, float((a.float() - b.float()).abs().max()))
    if differ:
        raise AssertionError(f"fused AdamW differs from the eager loop in "
                             f"{len(differ)} tensors (largest difference "
                             f"{max_abs_err}): {differ[:8]}")
    if launched != (1, len(ps)):
        raise AssertionError(f"the XL update took {launched} (launches, leaves), "
                             f"not (1, {len(ps)})")
    print(f"adamw phase: fused AdamW equals the eager loop bit for bit in all "
          f"{4 * len(ps)} tensors of GPT-2 XL's {len(ps)} leaves ({n_params} "
          f"parameters, bf16 with an f32 master), in one launch; largest "
          f"difference {max_abs_err}")

    card = card_line()
    rec = device_and_host_in_turns({"ms": kernel}, {"ms": 10}, 4, torch)
    rec.update(time_in_turns({"kernel_events_ms": kernel, "plain_ms": loop}, 2, 4,
                             torch))
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    rec["plain_ms_host"] = sorted(host)[1]
    del plain, loop
    torch.cuda.empty_cache()
    # the yardstick: PyTorch's fused AdamW over f32 parameters and gradients
    # of the same shapes (read p, g, m, v; write p, m, v: 28 bytes too)
    lib_params = [m.clone().requires_grad_() for m in opt["master"]]
    for p, gr in zip(lib_params, grads):
        p.grad = gr.to(torch.float32)
    lib = torch.optim.AdamW(lib_params, lr=ADAMW_HYPER["lr"], betas=(0.9, 0.95),
                            eps=1e-8, weight_decay=0.01, fused=True)
    rec.update(time_in_turns({"kernel_events_2_ms": kernel, "library_ms": lib.step},
                             10, 4, torch))
    del lib, lib_params
    rec["bound_ms"] = adamw_counts.adamw_bound_s(n_params) * 1e3
    rec["bound_by"] = "bytes"
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec.update(leaves=len(ps), params=n_params, launches=launched[0],
               max_abs_err=max_abs_err, differing_elements=sum(d[2] for d in differ))
    print(f"adamw phase: GPT-2 XL ({len(ps)} leaves, {n_params} parameters): "
          f"kernel {rec['ms']:.3f} ms on the card ({rec['ms_host'] * 1e3:.1f} us "
          f"of host enqueue; {rec['kernel_events_ms']:.3f} / "
          f"{rec['kernel_events_2_ms']:.3f} ms by events in the turns), bound "
          f"{rec['bound_ms']:.3f} ms (bytes, {100 * rec['bound_share']:.1f}% of "
          f"it); eager loop {rec['plain_ms']:.3f} ms by events, "
          f"{rec['plain_ms_host']:.1f} ms of host enqueue; "
          f"torch.optim.AdamW(fused=True) over f32 {rec['library_ms']:.3f} ms "
          f"(a yardstick; {card})")
    met = rec["bound_share"] >= 0.8
    print(f"adamw phase: at least 80% of the bytes bound: {'met' if met else 'NOT met'}")
    del model, opt, ps, grads, fused, table
    torch.cuda.empty_cache()
    return rec


def _same_bytes(torch, a, b) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def pinned_copy_check(torch, staging, nbytes: int) -> dict:
    """One device-to-host copy of ``nbytes`` into a registered shm segment,
    as staging makes it: the segment must read as pinned, and the copy's
    enqueue must return well before the transfer ends (a copy into
    pageable memory would block for all of it).  Returns the times and
    the rate."""
    from tpu_resiliency_torch.utils.shm import create_shm, unlink_shm

    dev = torch.device("cuda", torch.cuda.current_device())
    src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
    shm = create_shm(nbytes)
    addr = staging.pin_shm(shm)
    try:
        dst = torch.frombuffer(shm.buf, dtype=torch.uint8, count=nbytes)
        pinned = dst.is_pinned()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            with torch.cuda.stream(staging.copy_stream(dev)):
                t0 = time.perf_counter()
                (ev,) = staging.async_d2h([(dst, src)])
                t1 = time.perf_counter()
                ev.synchronize()
                t2 = time.perf_counter()
            runs.append((t1 - t0, t2 - t0))
        same = torch.equal(dst, src.cpu())
        del dst
    finally:
        staging.unpin(addr)
        shm.close()
        unlink_shm(shm)
    enqueue_s, total_s = sorted(runs, key=lambda r: r[1])[len(runs) // 2]
    rec = {"nbytes": nbytes, "pinned": pinned, "enqueue_ms": enqueue_s * 1e3,
           "total_ms": total_s * 1e3, "gb_per_s": nbytes / total_s / 1e9}
    print(f"ckpt phase: {nbytes} B device-to-host into registered shm: pinned "
          f"{pinned}, enqueue {rec['enqueue_ms']:.3f} ms, done after "
          f"{rec['total_ms']:.3f} ms, {rec['gb_per_s']:.2f} GB/s (median of 5)")
    if not (pinned and same and enqueue_s < 0.5 * total_s):
        raise AssertionError(f"the copy into registered shm is not asynchronous "
                             f"or not right: {rec}, equal {same}")
    return rec


def ckpt_phase(torch, tr, dd, ckpt_mod, tree_mod, params, opt, step, fq, batch,
               train_step_ms: float) -> dict:
    """Four saves of the full-width train state through the async
    checkpointer, each restored onto the card and compared bit for bit."""
    leaves = tree_mod.leaves
    root = tempfile.mkdtemp(prefix="tpurx_ckpt_")
    ck = ckpt_mod.AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    tree = tr.state_tree(params, opt)
    total = sum(t.numel() * t.element_size() for t in leaves(tree))
    n_leaves = len(leaves(tree))
    print(f"ckpt phase: train state {n_leaves} leaves, {total} B, "
          f"{sum(t.is_cuda for t in leaves(tree))} on the card")
    from tpu_resiliency_torch.checkpointing.async_ckpt import staging

    pinned = pinned_copy_check(torch, staging, 1 << 28)
    saves = {}
    copies = {}
    try:
        dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
        for g in SAVES:
            if g == "C":
                with torch.no_grad():
                    params.embed[0, 0] += 1.0
            tree = tr.state_tree(params, opt)
            copies[g] = [t.clone() for t in leaves(tree)]
            torch.cuda.synchronize()
            launches0 = dd.batch_fingerprints.launches
            shards0 = dd.batch_fingerprints.shards
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            ck.async_save(tree, os.path.join(root, g), {"iteration": g})
            call_s = time.perf_counter() - t0
            end.record()
            rec = {"call_ms": call_s * 1e3}
            if g in DRAIN_STEP_SAVES:
                step_s = []
                for _ in range(DRAIN_STEPS):
                    t1 = time.perf_counter()
                    fq.beat()
                    params, opt, _loss = step(params, opt, batch)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t1)
                written, owed = ck.drain_progress()
                rec["steps_during_drain_ms"] = [v * 1e3 for v in step_s]
                rec["drain_progress_after_steps"] = [written, owed]
            t1 = time.perf_counter()
            ck.finalize_all()
            rec["finalize_wait_ms"] = (time.perf_counter() - t1) * 1e3
            end.synchronize()
            rec["snapshot_span_ms"] = start.elapsed_time(end)
            rec["launches"] = dd.batch_fingerprints.launches - launches0
            rec["shards"] = dd.batch_fingerprints.shards - shards0
            rec.update(ck.last_stage_stats)
            drain = ck.last_drain_stats
            rec["drain_ms"] = drain.get("drain_ns", 0) / 1e6
            rec["bytes_written"] = drain.get("bytes_written")
            rec["drain_d2h_skipped_bytes"] = drain.get("d2h_skipped_bytes")
            saves[g] = rec
            print(f"ckpt phase: save {g}: async_save {rec['call_ms']:.2f} ms of "
                  f"host time, snapshot span {rec['snapshot_span_ms']:.3f} ms on "
                  f"the stream, fingerprints {rec['launches']} launch(es) over "
                  f"{rec['shards']} leaves in "
                  f"{rec['device_digest_launch_s'] * 1e3:.3f} ms + readback: "
                  f"{rec['device_digest_s'] * 1e3:.2f} ms, D2H {rec['d2h_bytes']} B "
                  f"in {rec['d2h_shards']} shards (enqueue "
                  f"{rec['d2h_enqueue_s'] * 1e3:.3f} ms), skipped "
                  f"{rec['d2h_skipped_bytes']} B, staging {rec['stage_s'] * 1e3:.2f} "
                  f"ms ({rec['segment_s'] * 1e3:.2f} ms creating and registering "
                  f"shm), drain {rec['drain_ms']:.1f} ms, {rec['bytes_written']} B "
                  f"written, finalize wait {rec['finalize_wait_ms']:.1f} ms")
            if g in DRAIN_STEP_SAVES:
                print(f"ckpt phase: steps while save {g} drained: "
                      f"{[round(v, 2) for v in rec['steps_during_drain_ms']]} ms "
                      f"(train phase mean {train_step_ms:.2f} ms); drain progress "
                      f"after them {rec['drain_progress_after_steps']}")
        dd_launches = dd.batch_fingerprints.launches
        dd_shards = dd.batch_fingerprints.shards
        a, a2, b, c = (saves[g] for g in SAVES)
        embed_bytes = params.embed.numel() * params.embed.element_size()
        for claim, met in (
            ("A transfers every byte", a["d2h_bytes"] == total
             and a["d2h_skipped_bytes"] == 0),
            ("A2, after three steps, transfers every byte",
             a2["d2h_bytes"] == total and a2["d2h_skipped_bytes"] == 0),
            ("B skips every owned byte", b["d2h_skipped_bytes"] == total
             and b["d2h_bytes"] == 0 and b["bytes_written"] == 0),
            ("C transfers exactly the changed shard", c["d2h_shards"] == 1
             and c["d2h_bytes"] == embed_bytes
             and c["d2h_skipped_bytes"] == total - embed_bytes),
            ("one fingerprint launch per save, over every device leaf",
             all(saves[g]["launches"] == 1 and saves[g]["shards"] == n_leaves
                 for g in saves)
             and dd_launches == len(SAVES) and dd_shards == len(SAVES) * n_leaves),
        ):
            print(f"ckpt phase: {claim}: {'met' if met else 'NOT met'}")
            if not met:
                raise AssertionError(f"ckpt phase: {claim} failed: {saves}")
    finally:
        ck.close()
    # every save restored onto the card from its files (no resident copy)
    restore = {}
    for g in SAVES:
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(os.path.join(root, g),
                                       tr.state_tree(params, opt), resident=False)
        torch.cuda.synchronize()
        restore[g] = (time.perf_counter() - t0) * 1e3
        got = leaves(out)
        if len(got) != n_leaves or not all(
                x.device == y.device and x.dtype == y.dtype
                and _same_bytes(torch, x, y) for x, y in zip(got, copies[g])):
            raise AssertionError(f"ckpt phase: save {g} does not restore bit for bit")
    print(f"ckpt phase: saves {', '.join(SAVES)} restored onto the card bit for "
          f"bit in {' / '.join(f'{restore[g]:.0f}' for g in SAVES)} ms")
    shutil.rmtree(root, ignore_errors=True)
    return {"saves": saves, "launches": dd_launches, "shards": dd_shards,
            "restore_ms": restore,
            "total_bytes": total, "n_leaves": n_leaves, "pinned_copy": pinned}


def _shm_segments() -> set:
    try:
        return set(os.listdir("/dev/shm"))
    except OSError:
        return set()


class _LogTail(logging.Handler):
    """Keeps the last ``keep`` warnings of the package's loggers."""

    def __init__(self, keep: int = 12):
        super().__init__(logging.WARNING)
        self.keep = keep
        self.lines = []

    def emit(self, record):
        self.lines = [*self.lines[1 - self.keep:], record.getMessage()]


def _wrap_run(torch, cfg, batch_size: int, seq: int, device, steps: int,
              faults: dict, store_factory, on_step=None, scheduler=None,
              fault_offset: bool = False, on_iteration=None) -> dict:
    """The trainer under the port's ``Wrapper`` from the seed-0 state:
    saves every ``WRAP_SAVE_EVERY`` steps (or, given a ``scheduler``, at
    each step its ``due()`` answers True), restores the last committed save
    after each fault (``faults``: iteration -> (kind, step), the step
    counted from the iteration's first step with ``fault_offset``), calls
    ``on_iteration(call_wrapper)`` as each iteration starts and
    ``on_step(step)`` before each step of iteration 0.  A run that ends at
    ``max_iterations`` fails with every exception the trainer raised that
    no fault injected and the package's last warnings.  Returns what the
    phases check."""
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
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
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.utils.tree import leaves

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # bit-for-bit losses across a restore need deterministic kernels (the
    # embedding's backward accumulates); cuBLAS asks for a fixed workspace
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    batch = tr.make_batch(cfg, batch_size, seq, seed=0, device=device)
    plain_step = tr.make_train_step(cfg, lr=1e-3)

    def fresh_state():
        params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                device=device)
        return {"params": params, "opt": tr.init_opt_state(params)}

    shm_before = _shm_segments()
    root = tempfile.mkdtemp(prefix="tpurx_wrap_")
    ck = ckpt_mod.AsyncCheckpointer(delta=True, digest=True, device_digest=True)
    probe = DeviceProbeHealthCheck(device=device)
    st = fresh_state()
    run = {"s": 0, "saved": {}, "committed": [], "aborted": set(), "faults": [],
           "losses": [], "init_ms": [], "records": {}, "ladders": [], "errors": []}

    def initialize(state):
        t0 = time.perf_counter()
        init_distributed(device=device)
        run["init_ms"].append((time.perf_counter() - t0) * 1e3)

    def save_dir(s):
        return os.path.join(root, f"step{s:04d}")

    def restore(cw):
        it = cw.iteration
        # the abort ladder killed the save still draining at the fault: it
        # never commits, whatever step a later iteration reaches
        run["aborted"].update(k for k in run["saved"] if k not in run["committed"])
        if not run["faults"] or run["faults"][-1]["iteration"] != it - 1:
            # a restart no injected fault caused (a false trip): recorded,
            # so the phase's claims fail; max_iterations ends the run
            run["faults"].append({"iteration": it - 1, "kind": "unexpected",
                                  "step": run["s"],
                                  "t_ns": cw.trip_ns.get(it - 1, time.monotonic_ns()),
                                  "launches": {}})
        fault = run["faults"][-1]
        fault["trip_ms"] = (cw.trip_ns[it - 1] - fault["t_ns"]) / 1e6
        fault["records"] = [(r.rank, r.interruption.value)
                            for r in cw.ops.get_interruptions(it - 1)]
        fault["ladder_ms"] = {r.stage: round(r.duration_ms, 3)
                              for r in cw.last_ladder_results}
        fault["ladder_outcomes"] = {r.stage: r.outcome
                                    for r in cw.last_ladder_results}
        run["ladders"].append(fault["ladder_outcomes"])
        fault["probe_ms"] = probe.last_probe_s * 1e3
        fault["init_ms"] = run["init_ms"][-1]
        if cw.quorum.trip_time is not None and fault["kind"] == "quorum_freeze":
            fault["lane_trip_ms"] = (cw.quorum.trip_time * 1e9 - fault["t_ns"]) / 1e6
        s = max(run["committed"])
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(
            save_dir(s), tr.state_tree(st["params"], st["opt"]), resident=False)
        sync()
        fault["restore_ms"] = (time.perf_counter() - t0) * 1e3
        got, want = leaves(out), run["saved"][s]
        if len(got) != len(want) or not all(
                x.device == y.device and x.dtype == y.dtype
                and _same_bytes(torch, x, y) for x, y in zip(got, want)):
            raise AssertionError(f"wrap phase: save {s} does not restore bit for bit")
        tr.load_state_tree(st["params"], st["opt"], out)
        fault["restored_from"] = s
        fault["steps_lost"] = fault["step"] - s
        run["s"] = s

    def train(call_wrapper=None):
        try:
            return trainer(call_wrapper)
        except Exception as exc:
            if not str(exc).startswith("injected exception"):
                run["errors"].append((call_wrapper.iteration, run["s"], repr(exc)))
            raise

    def trainer(cw):
        it = cw.iteration
        if it > 0:
            restore(cw)
        if on_iteration is not None:
            on_iteration(cw)
        step = cw.quorum.fuse(plain_step)
        fault = faults.get(it)
        if fault is not None and fault_offset:
            fault = (fault[0], run["s"] + fault[1])
        first = it > 0
        while run["s"] < steps:
            s = run["s"]
            # a step already saved (the one a restore resumed from) is not
            # offered to the scheduler
            due = s not in run["saved"] and (
                scheduler.due() if scheduler is not None else s % WRAP_SAVE_EVERY == 0)
            if due:
                tree = tr.state_tree(st["params"], st["opt"])
                run["saved"][s] = [t.clone() for t in leaves(tree)]
                ck.async_save(tree, save_dir(s), {"step": s})
                if scheduler is not None:
                    scheduler.note_saved()
            cw.ping()
            if on_step is not None and it == 0:
                on_step(s)
            if fault is not None and s == fault[1]:
                kind = fault[0]
                run["faults"].append({
                    "iteration": it, "kind": kind, "step": s,
                    "t_ns": time.monotonic_ns(),
                    # kernel launches of the wrapped run up to this fault
                    "launches": {"quorum_local_max": q.local_max.launches,
                                 **fp_counts(dd)}})
                print(f"wrap phase: iteration {it}: {kind} at step {s}", flush=True)
                if kind == "exception":
                    raise RuntimeError(f"injected exception at step {s}")
                if kind == "stall":
                    while True:       # no pings; C-level sleeps past the soft timeout
                        time.sleep(WRAP_STALL_SLEEP_S)
                cw.quorum.monitor.stop_auto_beat()
                while True:           # no pings, no beats; bytecode keeps running
                    time.sleep(0.05)
            st["params"], st["opt"], loss = step(st["params"], st["opt"], batch)
            loss = float(loss)
            run["losses"].append((it, s, loss))
            run["s"] = s + 1
            if first:
                run["faults"][-1]["restart_ms"] = (
                    time.monotonic_ns() - run["faults"][-1]["t_ns"]) / 1e6
                first = False
            if (s in run["saved"] and s not in run["committed"]
                    and s not in run["aborted"]):
                ck.maybe_finalize(blocking=True)   # the save drained under step s
                run["committed"].append(s)
        step.check_now()
        return f"done@{it}"

    ladder = default_ladder(None, None, None, AbortCheckpointWorkers(ck.queue),
                            AbortQuorumMonitor())
    wrapper = Wrapper(
        store_factory=store_factory,
        initialize=initialize, abort=ladder, health_check=probe,
        soft_timeout=WRAP_SOFT_TIMEOUT_S, hard_timeout=300.0,
        monitor_process_interval=0.1, monitor_thread_interval=0.05,
        last_call_wait=0.05, barrier_timeout=120.0,
        quorum_mesh=lambda: make_mesh(("all",), device=device),
        quorum_budget_ms=WRAP_QUORUM_BUDGET_MS, quorum_interval=0.01,
        quorum_auto_beat_interval=0.005, quorum_calibrate=False,
        max_iterations=len(faults) + 1,
    )
    q.local_max.launches = 0
    dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
    os.environ["TPURX_RANK"], os.environ["TPURX_WORLD_SIZE"] = "0", "1"
    tail = _LogTail()
    logging.getLogger("tpurx").addHandler(tail)
    t0 = time.perf_counter()
    try:
        ret = wrapper(train)()
    except RestartAbort as exc:
        raise AssertionError(
            f"wrapped run: {exc}: injected faults "
            f"{[(f['iteration'], f['kind'], f['step']) for f in run['faults']]}, "
            f"other exceptions (iteration, step, error) {run['errors']}, the "
            f"package's last warnings {tail.lines}") from exc
    finally:
        logging.getLogger("tpurx").removeHandler(tail)
        ck.close()
        resident.invalidate()  # the last save's warm-restore copy in shm
        import torch.distributed as dist

        from tpu_resiliency_torch.parallel import distributed as dist_mod

        if dist.is_initialized():
            dist.destroy_process_group()
        dist_mod.reset()
        torch.use_deterministic_algorithms(False)
    wall_s = time.perf_counter() - t0
    launches = {"quorum_local_max": q.local_max.launches, **fp_counts(dd)}
    shutil.rmtree(root, ignore_errors=True)
    return {"ret": ret, "run": run, "launches": launches, "wall_s": wall_s,
            "leaked": sorted(_shm_segments() - shm_before)}


def _ladder_released(outcomes: dict, shrink: bool) -> bool:
    """Every stage of a restart's ladder released, and the opt-in mesh
    shrink (``TPURX_SHRINK_MESH``) released exactly when it is on."""
    rest = {k: v for k, v in outcomes.items() if k != "shrink_mesh"}
    return (bool(rest) and set(rest.values()) == {"released"}
            and outcomes.get("shrink_mesh") == ("released" if shrink else "skipped"))


def wrap_phase(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """The in-process restart ring around the trainer (phase 10).  On the
    card with ``device=None``; ``device="cpu"`` rehearses it on the CPU at a
    small ``cfg`` (kernels then take their plain versions)."""
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.store import StoreFactory, StoreServer

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    batch = tr.make_batch(cfg, batch_size, seq, seed=0, device=device)
    plain_step = tr.make_train_step(cfg, lr=1e-3)
    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=device)
    st = {"params": params, "opt": tr.init_opt_state(params)}
    reference = []
    for _ in range(WRAP_STEPS):
        st["params"], st["opt"], loss = plain_step(st["params"], st["opt"], batch)
        reference.append(float(loss))
    del st, params
    print(f"wrap phase: reference run, {WRAP_STEPS} steps uninterrupted: losses "
          f"{[round(v, 4) for v in reference]}")

    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    try:
        out = _wrap_run(torch, cfg, batch_size, seq, device, WRAP_STEPS, WRAP_FAULTS,
                        StoreFactory("127.0.0.1", server.port, timeout=60.0))
    finally:
        server.stop()
    ret, run, launches = out["ret"], out["run"], out["launches"]
    wall_s, leaked = out["wall_s"], out["leaked"]

    faults = run["faults"]
    n_leaves = len(next(iter(run["saved"].values())))
    print(f"wrap phase: wrapper returned {ret!r} after {wall_s:.2f} s; "
          f"{len(run['losses'])} steps run, saves {sorted(run['saved'])} "
          f"(committed {sorted(run['committed'])}); kernel launches in the "
          f"wrapped run {launches}")
    want_records = {"exception": "exception", "stall": "soft_timeout",
                    "quorum_freeze": "quorum_stale"}
    for f in faults:
        print(f"wrap phase: fault {f['kind']} (iteration {f['iteration']}, step "
              f"{f['step']}): records {f.get('records')}; detection "
              f"{f.get('trip_ms', float('nan')):.2f} ms"
              + (f" (tick lane {f['lane_trip_ms']:.2f} ms)" if "lane_trip_ms" in f else "")
              + f"; ladder {f.get('ladder_ms')} ms "
              f"{f.get('ladder_outcomes')}; process group rebuilt in "
              f"{f.get('init_ms', float('nan')):.2f} ms; health probe "
              f"{f.get('probe_ms', float('nan')):.2f} ms; restore from step "
              f"{f.get('restored_from')} in {f.get('restore_ms', float('nan')):.2f} "
              f"ms; restart latency {f.get('restart_ms', float('nan')):.2f} ms; "
              f"steps lost {f.get('steps_lost')}; kernel launches before it "
              f"{f['launches']}")
    mismatched = [(it, s, v, reference[s]) for it, s, v in run["losses"]
                  if v != reference[s]]
    for claim, met in (
        ("the wrapper returned from the fourth iteration", ret == "done@3"),
        ("three faults, each restored", len(faults) == 3
         and all("restore_ms" in f and "restart_ms" in f for f in faults)),
        ("each fault detected by its own detector", all(
            (0, want_records[f["kind"]]) in f.get("records", ()) for f in faults)),
        ("every loss equals the uninterrupted run's bit for bit",
         not mismatched and run["s"] == WRAP_STEPS),
        ("every abort stage released, the opt-in mesh shrink skipped", all(
            _ladder_released(f["ladder_outcomes"], shrink=False) for f in faults)),
        ("the local max and the fingerprint ran in the wrapped run", not on_card
         or (launches["quorum_local_max"] > 0 and launches["chunk_fingerprint"] > 0)),
        ("each fingerprint launch covered every leaf of its save", not on_card
         or launches["chunk_fingerprint_shards"]
         == n_leaves * launches["chunk_fingerprint"]),
        ("no shared-memory segment leaked", not leaked),
    ):
        print(f"wrap phase: {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(
                f"wrap phase: {claim} failed: faults {faults}, mismatched "
                f"losses {mismatched[:5]}, leaked {leaked}")
    return {"faults": faults, "launches": launches, "steps": len(run["losses"]),
            "wall_s": wall_s, "reference": reference}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# in-job phase: the launcher's restart ring around the trainer worker
INJOB_WORKER = os.path.join("tests", "workloads", "torch_ft_worker.py")
INJOB_STEPS, INJOB_SAVE_EVERY = 24, 4
# cycle -> (kind, step, rank): a crash, a missed heartbeat, a frozen quorum beat
INJOB_FAULTS = {0: ("crash", 6, 0), 1: ("heartbeat", 11, 0), 2: ("quorum", 17, 0)}
INJOB_HEARTBEAT_TIMEOUT_S = 5.0
INJOB_QUORUM_BUDGET_MS = 500.0
INJOB_MAX_STEPS_LOST = 4
# part (c): two workers share the card over gloo on a (2, 1) mesh at the
# JAX package's tiny config; rank 1 crashes at step 3 of cycle 0
INJOB_TINY = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=256, max_seq=64)
INJOB_TWO_STEPS, INJOB_TWO_BATCH, INJOB_TWO_SEQ = 8, 4, 64
INJOB_TWO_FAULTS = {0: ("crash", 3, 1)}
INJOB_BOUND_S = 300.0
INJOB_RUN_TIMEOUT_S = {"clean": 150.0, "faults": 240.0, "gate": 90.0,
                       "two_clean": 120.0, "two_faults": 150.0}


def _free_port_run(n: int = 2) -> int:
    """A port P with P .. P + n - 1 free: by default the launcher's store and
    the process group's TCP rendezvous at store port + 1
    (``init_distributed``); the shards and spares of a control plane."""
    import socket

    for _ in range(100):
        port = _free_port()
        socks = []
        try:
            for i in range(1, n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", port + i))
            return port
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} free consecutive ports")


def _jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _ft_env(out: str, env_extra: dict) -> dict:
    """The environment of a port launcher around the trainer worker."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPURX_", "FT_", "CHIP_SMOKE"))}
    env.update({
        "TPURX_REPO": HERE, "FT_OUT": out,
        "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": str(INJOB_HEARTBEAT_TIMEOUT_S),
        "TPURX_FT_INITIAL_RANK_HEARTBEAT_TIMEOUT": "180",
        "TPURX_FT_WORKLOAD_CHECK_INTERVAL": "0.1",
        "TPURX_FT_WORKERS_STOP_TIMEOUT": "10",
        "TPURX_FT_RDZV_ROUND_TIMEOUT": "120",
        "TPURX_FT_PROGRESS_ITERATION_FILE": os.path.join(out, "progress.txt"),
        "TPURX_PROFILING_FILE": os.path.join(out, "profiling.jsonl"),
        "FT_QUORUM_BUDGET_MS": str(INJOB_QUORUM_BUDGET_MS),
        "FT_SAVE_EVERY": str(INJOB_SAVE_EVERY),
    })
    env.update(env_extra)
    return env


def _start_launcher(out: str, tag: str, env: dict, args: list) -> subprocess.Popen:
    """The port's launcher CLI in a session of its own (a kill of the group
    takes every worker it started), logging to ``<tag>.out``/``.err``."""
    cmd = [sys.executable, "-m", "tpu_resiliency_torch.fault_tolerance.launcher",
           *args, "--max-restarts", "3", "--monitor-interval", "0.05",
           os.path.join(HERE, INJOB_WORKER)]
    with open(os.path.join(out, f"{tag}.out"), "w") as fo, \
            open(os.path.join(out, f"{tag}.err"), "w") as fe:
        return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=fo, stderr=fe,
                                start_new_session=True)


def _wait_or_kill(proc: subprocess.Popen, deadline: float):
    """The exit code of ``proc`` (a session leader), or None after killing
    its group at the deadline (``time.monotonic()``): the launcher and every
    worker it started, or the control plane and its shards."""
    try:
        return proc.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        return None


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _collect(name: str, out: str, rc, wall_s: float, tags=("launcher",),
             profiling=("profiling.jsonl",)) -> dict:
    """What a launcher run left: exit code, wall time, the launchers' logs
    and probes, the profiling events and the workers' event and loss files."""
    err = "".join(_read(os.path.join(out, f"{t}.err")) for t in tags)
    stdout = "".join(_read(os.path.join(out, f"{t}.out")) for t in tags)
    probes = []
    for line in err.splitlines():
        if "device probe: healthy=" in line:
            tail = line.split("device probe: ", 1)[1]
            head, _, stats = tail.partition(" stats=")
            rec = dict(kv.split("=", 1) for kv in head.split())
            probes.append({"healthy": rec["healthy"] == "True",
                           "cached": rec["cached"] == "True",
                           "ms": float(rec["ms"]), "stats": json.loads(stats)})
    ranks = sorted(int(f[len("events.r"):-len(".jsonl")]) for f in os.listdir(out)
                   if f.startswith("events.r"))
    return {
        "name": name, "rc": rc, "wall_s": wall_s, "stdout": stdout, "stderr": err,
        "probes": probes,
        "profiling": sorted((e for p in profiling
                             for e in _jsonl(os.path.join(out, p)) if "mono_ns" in e),
                            key=lambda e: e["mono_ns"]),
        "events": {r: _jsonl(os.path.join(out, f"events.r{r}.jsonl")) for r in ranks},
        "losses": {r: _jsonl(os.path.join(out, f"losses.r{r}.jsonl")) for r in ranks},
    }


def _launch(name: str, out: str, nproc: int, env_extra: dict, timeout: float) -> dict:
    """One run of the port's launcher CLI hosting its store, with the trainer
    worker; returns its exit code, wall time and the files it left."""
    os.makedirs(out, exist_ok=True)
    t0 = time.monotonic()
    proc = _start_launcher(out, "launcher", _ft_env(out, env_extra), [
        "--nnodes", "1", "--nproc-per-node", str(nproc),
        "--rdzv-endpoint", f"127.0.0.1:{_free_port_run()}", "--host-store"])
    rc = _wait_or_kill(proc, t0 + timeout)
    run = _collect(name, out, rc, time.monotonic() - t0)
    print(f"injob phase: {name}: launcher exit {rc} after {run['wall_s']:.2f} s; "
          f"ranks {sorted(run['events'])}; probes "
          f"{[(p['healthy'], p['cached'], round(p['ms'], 1)) for p in run['probes']]}",
          flush=True)
    return run


def _event(run: dict, rank: int, cycle: int, name: str):
    return next((e for e in run["events"].get(rank, ())
                 if e["cycle"] == cycle and e["event"] == name), None)


def _prof(run: dict, name: str, after_ns: int, **match):
    return next((e for e in run["profiling"] if e.get("event") == name
                 and e["mono_ns"] >= after_ns
                 and all(e.get(k) == v for k, v in match.items())), None)


def _launches(run: dict, rank: int, cycle: int) -> dict:
    for name in ("fault", "done"):
        e = _event(run, rank, cycle, name)
        if e is not None:
            return e["launches"]
    # a worker the launcher stopped: the counts at its last save's commit
    commits = [e for e in run["events"].get(rank, ())
               if e["cycle"] == cycle and e["event"] == "committed"]
    return commits[-1]["launches"] if commits else {}


def _fp_per_save(runs) -> bool:
    """Kernel 2 in the workers of ``runs``, at each commit and at each
    cycle's end: one launch per save so far over the rank's owned shards
    (no launch on a rank that owns none), and at least one such save."""
    seen = False
    for run in runs:
        for evs in run["events"].values():
            for e in evs:
                if e["event"] not in ("committed", "done"):
                    continue
                n, owned, got = e["saves"], e["owned"], e["launches"]
                if (got["chunk_fingerprint"], got["chunk_fingerprint_shards"]) != (
                        n if owned else 0, owned * n):
                    return False
                seen = seen or (n > 0 and owned > 0)
    return seen


def _injob_faults(run: dict, faults: dict) -> list:
    """Detection, restart latency and steps lost of each fault, from the
    worker's events and the launcher's profiling events (CLOCK_MONOTONIC ns
    on one host)."""
    rows = []
    for cycle, (kind, step, rank) in sorted(faults.items()):
        ev = _event(run, rank, cycle, "fault")
        nxt = _event(run, rank, cycle + 1, "first_step")
        ready = _event(run, rank, cycle + 1, "ready")
        row = {"cycle": cycle, "kind": kind, "step": step, "rank": rank,
               "injected": ev is not None}
        if ev is not None:
            t = ev["ns"]
            if kind == "heartbeat":
                det = _prof(run, "hang_detected", t)
            elif kind == "quorum":
                det = _prof(run, "failure_detected", t, source="workload_control")
            else:
                det = _prof(run, "failure_detected", t)
            row["detected_by"] = det and (det["event"] + (
                f"/{det['source']}" if det.get("source") else ""))
            row["detection_ms"] = det and (det["mono_ns"] - t) / 1e6
            row["hang_detected"] = _prof(run, "hang_detected", t) is not None and (
                _prof(run, "hang_detected", t)["mono_ns"]
                < (nxt["ns"] if nxt else float("inf")))
            row["launches_before"] = ev["launches"]
            if nxt is not None:
                row["restart_ms"] = (nxt["ns"] - t) / 1e6
            if ready is not None:
                row["restored_from"] = ready["restored_from"]
                row["steps_lost"] = step - (ready["restored_from"] or 0)
        rows.append(row)
    return rows


def _injob_cycles(run: dict, rank: int) -> list:
    """Spawn (the launcher's ``worker_start_requested``) to the first finished
    step of each cycle, with the worker's own split of it."""
    rows = []
    cycles = sorted({e["cycle"] for e in run["events"].get(rank, ())})
    for c in cycles:
        spawn = next((e for e in run["profiling"]
                      if e.get("event") == "worker_start_requested"
                      and e.get("cycle") == c), None)
        ready = _event(run, rank, c, "ready")
        first = _event(run, rank, c, "first_step")
        row = {"cycle": c, "launches": _launches(run, rank, c)}
        if ready is not None:
            row.update({k: ready[k] for k in ("import_cuda_ms", "dist_ms",
                                              "restore_ms", "restored_from")})
        if spawn is not None and first is not None:
            row["spawn_to_first_step_ms"] = (first["ns"] - spawn["mono_ns"]) / 1e6
        rows.append(row)
    return rows


def _bit_for_bit(clean: dict, faulted: list) -> list:
    """(cycle, step, loss, reference) of every faulted-run loss that differs
    from the uninterrupted run's at the same step."""
    return [(r["cycle"], r["step"], r["loss"], clean.get(r["step"])) for r in faulted
            if clean.get(r["step"]) != r["loss"]]


def injob_phase(torch, card: str, device=None) -> dict:
    """The in-job restart ring (phase 15): the port's launcher CLI, its
    rendezvous, rank monitors and pre-join CUDA probe around the trainer
    worker.  On the card with ``device=None``; ``device="cpu"`` rehearses it
    on the CPU at the tiny config (the probe is then off except in (b),
    where the CPU has no card to find, and no launch count is claimed)."""
    on_card = device is None
    dev = "cuda:0" if on_card else "cpu"
    root = tempfile.mkdtemp(prefix="tpurx_injob_")
    if on_card:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(0)
        print(f"injob phase: card memory in use before the phase "
              f"{(total - free) / 1e9:.2f} of {total / 1e9:.2f} GB ({card})")
    full = {"FT_DEVICE": dev, "FT_BACKEND": "nccl" if on_card else "gloo",
            "FT_STEPS": str(INJOB_STEPS),
            "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "1" if on_card else "0"}
    if on_card:
        full.update({"FT_CFG": "{}", "FT_BATCH": str(TRAIN_BATCH),
                     "FT_SEQ": str(TRAIN_SEQ)})
    else:
        full.update({"FT_CFG": json.dumps(INJOB_TINY), "FT_BATCH": "2",
                     "FT_SEQ": "32"})
    faults_json = json.dumps({str(c): list(v) for c, v in INJOB_FAULTS.items()})
    # (c) shows the cross-rank restart; (a) and (b) show the probe, so (c)
    # runs without it (each probe is a process start on the card)
    two = {"FT_DEVICE": dev, "FT_BACKEND": "gloo", "FT_MESH": "dp_tp",
           "FT_CFG": json.dumps(INJOB_TINY), "FT_BATCH": str(INJOB_TWO_BATCH),
           "FT_SEQ": str(INJOB_TWO_SEQ), "FT_STEPS": str(INJOB_TWO_STEPS),
           "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "0"}
    t_phase = time.monotonic()
    try:
        # (b) touches no card: it runs beside (a)'s uninterrupted run; that
        # run and then (c)'s two (tiny, over gloo) run beside (a)'s faulted
        # run, which the uninterrupted run's losses are compared with after
        gates, runs = [], {}
        gate_thread = threading.Thread(target=lambda: gates.append(_launch(
            "(b) no visible card", os.path.join(root, "gate"), 1,
            {**full, "CUDA_VISIBLE_DEVICES": "",
             "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "1"},
            INJOB_RUN_TIMEOUT_S["gate"])))

        def side():
            runs["clean"] = _launch("(a) uninterrupted", os.path.join(root, "clean"),
                                    1, full, INJOB_RUN_TIMEOUT_S["clean"])
            runs["two_clean"] = _launch(
                "(c) two workers, uninterrupted", os.path.join(root, "two_clean"), 2,
                two, INJOB_RUN_TIMEOUT_S["two_clean"])
            runs["two_faulted"] = _launch(
                "(c) two workers, rank 1 crashes", os.path.join(root, "two_faults"), 2,
                {**two, "FT_FAULTS": json.dumps(
                    {str(c): list(v) for c, v in INJOB_TWO_FAULTS.items()})},
                INJOB_RUN_TIMEOUT_S["two_faults"])

        side_thread = threading.Thread(target=side)
        gate_thread.start()
        side_thread.start()
        faulted = _launch("(a) three faults", os.path.join(root, "faults"), 1,
                          {**full, "FT_FAULTS": faults_json},
                          INJOB_RUN_TIMEOUT_S["faults"])
        gate_thread.join(timeout=INJOB_RUN_TIMEOUT_S["gate"] + 30)
        side_thread.join(timeout=sum(INJOB_RUN_TIMEOUT_S[k] for k in (
            "clean", "two_clean", "two_faults")) + 30)
        if not gates or len(runs) != 3:
            raise AssertionError("injob phase: a launcher run did not return")
        gate, clean = gates[0], runs["clean"]
        two_clean, two_faulted = runs["two_clean"], runs["two_faulted"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.monotonic() - t_phase

    ref = {r["step"]: r["loss"] for r in clean["losses"].get(0, ())}
    fault_rows = _injob_faults(faulted, INJOB_FAULTS)
    cycles = _injob_cycles(faulted, 0)
    clean_cycles = _injob_cycles(clean, 0)
    mismatched = _bit_for_bit(ref, faulted["losses"].get(0, []))
    last = max((r["cycle"] for r in faulted["losses"].get(0, [])), default=-1)
    steps_done = sorted({r["step"] for r in faulted["losses"].get(0, [])
                         if r["cycle"] == last})
    two_ref = {r: {x["step"]: x["loss"] for x in rows}
               for r, rows in two_clean["losses"].items()}
    two_mismatched = {r: _bit_for_bit(two_ref.get(r, {}), rows)
                      for r, rows in two_faulted["losses"].items()}
    two_cycles = {r: sorted({e["cycle"] for e in evs if e["event"] == "ready"})
                  for r, evs in two_faulted["events"].items()}
    injob_launches = {
        k: sum(c["launches"].get(k, 0) for run in (clean, faulted)
               for r in run["events"] for c in _injob_cycles(run, r))
        + sum(c["launches"].get(k, 0) for run in (two_clean, two_faulted)
              for r in run["events"] for c in _injob_cycles(run, r))
        for k in ("quorum_local_max", "chunk_fingerprint", "chunk_fingerprint_shards")}

    for f in fault_rows:
        print(f"injob phase: fault {f['kind']} (cycle {f['cycle']}, step {f['step']}): "
              f"detected by {f.get('detected_by')} in "
              f"{f.get('detection_ms') or float('nan'):.2f} ms; restart latency "
              f"{f.get('restart_ms', float('nan')):.2f} ms; restored from step "
              f"{f.get('restored_from')}, steps lost {f.get('steps_lost')}; kernel "
              f"launches before it {f.get('launches_before')} ({card})")
    for name, rows in (("uninterrupted", clean_cycles), ("three faults", cycles)):
        for c in rows:
            print(f"injob phase: {name}, cycle {c['cycle']}: spawn to first step "
                  f"{c.get('spawn_to_first_step_ms', float('nan')):.1f} ms (import + "
                  f"CUDA {c.get('import_cuda_ms', float('nan')):.1f}, process group "
                  f"{c.get('dist_ms', float('nan')):.1f}, restore "
                  f"{c.get('restore_ms') or 0.0:.1f} ms from step "
                  f"{c.get('restored_from')}); kernel launches {c['launches']} ({card})")
    for run in (clean, faulted, gate):
        for p in run["probes"]:
            print(f"injob phase: {run['name']}: device probe healthy={p['healthy']} "
                  f"cached={p['cached']} {p['ms']:.1f} ms, stats {p['stats']} ({card})")
    print(f"injob phase: (c) cycles per rank {two_cycles}; wall "
          f"{two_clean['wall_s']:.2f} / {two_faulted['wall_s']:.2f} s; kernel "
          f"launches in the workers {injob_launches}; phase {wall_s:.2f} s")

    want_detector = {"crash": "failure_detected", "heartbeat": "hang_detected",
                     "quorum": "failure_detected/workload_control"}
    two_started = [e for e in two_faulted["profiling"]
                   if e.get("event") == "worker_start_requested"]
    claims = (
        ("(a) the uninterrupted run exits 0 after every step",
         clean["rc"] == 0 and sorted(ref) == list(range(INJOB_STEPS))),
        ("(a) the faulted run exits 0 after four cycles, the last to the end",
         faulted["rc"] == 0 and last == len(INJOB_FAULTS)
         and steps_done and steps_done[-1] == INJOB_STEPS - 1),
        ("(a) each fault detected by its own detector", all(
            f.get("detected_by") == want_detector[f["kind"]] for f in fault_rows)),
        ("(a) the quorum trip restarts the cycle before the heartbeat timeout", all(
            f.get("detection_ms") is not None
            and f["detection_ms"] < INJOB_HEARTBEAT_TIMEOUT_S * 1e3
            and not f["hang_detected"]
            for f in fault_rows if f["kind"] == "quorum")),
        ("(a) every loss equals the uninterrupted run's bit for bit",
         not mismatched and bool(faulted["losses"].get(0))),
        (f"(a) at most {INJOB_MAX_STEPS_LOST} steps lost per fault", all(
            f.get("steps_lost") is not None
            and 0 <= f["steps_lost"] <= INJOB_MAX_STEPS_LOST for f in fault_rows)),
        ("(a) the CUDA probe gated the first join of each run", not on_card or all(
            run["probes"] and run["probes"][0]["healthy"]
            and not run["probes"][0]["cached"]
            and run["probes"][0]["stats"][0]["platform"] == "gpu"
            for run in (clean, faulted))),
        ("(a) kernels 1 and 2 launched in the workers", not on_card or (
            injob_launches["quorum_local_max"] > 0
            and injob_launches["chunk_fingerprint"] > 0)),
        ("kernel 2 launched once per save over each rank's owned leaves",
         not on_card or _fp_per_save((clean, faulted, two_clean, two_faulted))),
        ("(b) a node that sees no card leaves with UnhealthyNodeError, no worker",
         gate["rc"] not in (0, None) and "node unhealthy" in gate["stderr"]
         and not gate["events"]
         and not any(e.get("event") == "worker_start_requested"
                     for e in gate["profiling"])
         and gate["probes"] and not gate["probes"][0]["healthy"]),
        ("(c) both workers restart together and finish",
         two_clean["rc"] == 0 and two_faulted["rc"] == 0
         and two_cycles == {0: [0, 1], 1: [0, 1]}
         and len([e for e in two_started if e.get("cycle") == 1]) == 1),
        ("(c) every loss equals the uninterrupted two-worker run's bit for bit",
         set(two_faulted["losses"]) == {0, 1}
         and all(not m for m in two_mismatched.values())
         and all(len(two_ref.get(r, {})) == INJOB_TWO_STEPS for r in (0, 1))),
        (f"the phase within {INJOB_BOUND_S:.0f} s", wall_s <= INJOB_BOUND_S),
    )
    for claim, met in claims:
        print(f"injob phase: {claim}: {'met' if met else 'NOT met'}")
    failed = [c for c, met in claims if not met]
    if failed:
        for run in (clean, faulted, gate, two_clean, two_faulted):
            print(f"injob phase: {run['name']}: launcher stderr tail:\n"
                  f"{run['stderr'][-3000:]}\nstdout tail:\n{run['stdout'][-3000:]}")
        raise AssertionError(
            f"injob phase: {failed} failed: faults {fault_rows}, mismatched "
            f"{mismatched[:5]}, (c) mismatched {two_mismatched}, (c) cycles per "
            f"rank {two_cycles}, launcher exits "
            f"{ {run['name']: run['rc'] for run in (clean, faulted, gate, two_clean, two_faulted)} }")
    return {
        "faults": fault_rows, "cycles": cycles, "clean_cycles": clean_cycles,
        "probes": {run["name"]: run["probes"] for run in (clean, faulted, gate)},
        "gate_rc": gate["rc"], "two_cycles": two_cycles,
        "launches": injob_launches,
        "wall_s": {run["name"]: run["wall_s"] for run in
                   (clean, faulted, gate, two_clean, two_faulted)},
        "phase_s": wall_s,
        "clean_losses": ref,
    }


# control phase: the job-level control plane around the trainer worker
CONTROL_CP = "tpu_resiliency_torch.fault_tolerance.control_plane"
# (a) cycle 0: the worker SIGKILLs itself at step 6; cycle 1: the control
# plane is SIGKILLed once the progress file reads 12 (the save of step 12 is
# draining) and restarted from its journal on the same port 2 s later
CONTROL_CRASH = {0: ("crash", 6, 0)}
CONTROL_KILL_AT = 12
CONTROL_OUTAGE_S = 2.0
CONTROL_HEALTH_CHECKS = ("node_resources,nic_link,tpu_sys,kernel_log,"
                         "counter_window,node_daemon")
CONTROL_HEALTH_INTERVAL_S = 1.0
CONTROL_REJOIN_WINDOW_S = 120.0
# (b) the in-process ring over three shards and a spare: the shard of the
# ring's keys is SIGKILLed before step 7, an exception fault at step 10
CONTROL_B_STEPS = 16
CONTROL_B_KILL_STEP = 7
CONTROL_B_FAULTS = {0: ("exception", 10)}
# (c) two nodes and a hot spare at the tiny config: an application Xid on
# A's kernel log once the progress file reads 2, a hard Xid on B's at 5
CONTROL_C_STEPS, CONTROL_C_STEP_SLEEP_S = 12, 0.5
# the round closes as soon as max-nodes healthy nodes have joined; the
# settle window only bounds how long the host waits, once min-nodes have
# arrived, for the rest: after B's exclusion B rejoins at once and A only
# after stopping its worker, on a host shared with (a) and (b)
CONTROL_C_SETTLE_S = 10.0
CONTROL_C_XID_APP_AT, CONTROL_C_XID_HARD_AT = 2, 5
CONTROL_XID_APP = "NVRM: Xid (PCI:0000:00:00): 43, pid={pid}, name=python, Ch 00000008"
CONTROL_XID_HARD = "NVRM: Xid (PCI:0000:00:00): 79, pid={pid}, GPU has fallen off the bus."
CONTROL_BOUND_S = 240.0
CONTROL_RUN_TIMEOUT_S = {"a": 200.0, "c_clean": 100.0, "c_faults": 130.0}


def _wait_port(port: int, timeout: float) -> bool:
    import socket

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return True
        time.sleep(0.02)
    return False


def _start_control_plane(out: str, tag: str, port: int, *args) -> subprocess.Popen:
    """``python -m tpu_resiliency_torch.fault_tolerance.control_plane`` in a
    session of its own (a kill of the group takes its shard processes)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TPURX_", "FT_"))}
    with open(os.path.join(out, f"{tag}.log"), "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", CONTROL_CP, "--host", "127.0.0.1",
             "--port", str(port), *args],
            cwd=HERE, env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)


def _progress(out: str) -> int:
    try:
        return int(_read(os.path.join(out, "progress.txt")).strip() or "0")
    except ValueError:
        return 0


def _health_runs(run: dict, check: str = "chained") -> list:
    return [e.get("healthy") for e in run["profiling"]
            if e.get("event") == "health_check_completed" and e.get("check") == check]


_PASSIVE_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from tpu_resiliency_torch.health import build_passive_checks
out = {}
for source in ("auto", sys.argv[3]):
    chain = build_passive_checks(sys.argv[2], kernel_log_source=source)
    chain.run()
    out[source] = {c.name: [r.healthy, r.message] for c, r in
                   ((c, c.run()) for c in chain.checks)}
    out[source + ":mode"] = [c._mode for c in chain.checks if c.name == "kernel_log"]
out["torch_loaded"] = "torch" in sys.modules
print(json.dumps(out))
"""


def _passive_host(klog: str) -> dict:
    """The passive chain as the rank monitor builds it, run in a fresh
    interpreter that imports no torch: each check's verdict on this host,
    with the kernel log's ``auto`` source and with ``klog``."""
    proc = subprocess.run(
        [sys.executable, "-c", _PASSIVE_SCRIPT, HERE, CONTROL_HEALTH_CHECKS, klog],
        capture_output=True, text=True, timeout=60, cwd=HERE)
    if proc.returncode != 0:
        raise AssertionError(f"control phase: the passive chain failed to run:\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _control_a(root: str, full: dict, ref: dict) -> dict:
    """(a): a launcher as a pure store client of the port's control plane."""
    from tpu_resiliency_torch.fault_tolerance.rendezvous import K_CYCLE
    from tpu_resiliency_torch.store import StoreClient

    out = os.path.join(root, "a")
    os.makedirs(out)
    klog = os.path.join(out, "kern.log")
    open(klog, "w").close()
    port = _free_port_run()
    journal = os.path.join(out, "cp.journal")
    t0 = time.monotonic()
    cps = [_start_control_plane(out, "cp0", port, "--journal", journal)]
    if not _wait_port(port, 30.0):
        _wait_or_kill(cps[0], 0.0)
        raise AssertionError(f"control phase (a): no control plane on {port}:\n"
                             f"{_read(os.path.join(out, 'cp0.log'))[-3000:]}")
    env = _ft_env(out, {
        **full, "FT_STEPS": str(INJOB_STEPS),
        "FT_FAULTS": json.dumps({str(c): list(v) for c, v in CONTROL_CRASH.items()}),
        "FT_STORE": "env", "TPURX_STORE_MUX": "1",
        "TPURX_FT_STORE_REJOIN_WINDOW": str(CONTROL_REJOIN_WINDOW_S),
        "TPURX_FT_MONITOR_HEALTH_CHECK_INTERVAL": str(CONTROL_HEALTH_INTERVAL_S),
        "TPURX_FT_MONITOR_HEALTH_CHECKS": CONTROL_HEALTH_CHECKS,
        "TPURX_FT_MONITOR_HEALTH_KERNEL_LOG": klog})
    proc = _start_launcher(out, "launcher", env, [
        "--nnodes", "1", "--nproc-per-node", "1", "--node-id", "nodeA",
        "--rdzv-endpoint", f"127.0.0.1:{port}"])
    deadline = t0 + CONTROL_RUN_TIMEOUT_S["a"]
    outage = {}
    events = os.path.join(out, "events.r0.jsonl")
    try:
        while proc.poll() is None and time.monotonic() < deadline:
            if (_progress(out) >= CONTROL_KILL_AT
                    and any(e["cycle"] == 1 and e["event"] == "first_step"
                            for e in _jsonl(events))):
                break
            time.sleep(0.02)
        if proc.poll() is None and time.monotonic() < deadline:
            probe = StoreClient("127.0.0.1", port, timeout=10.0)
            outage["cycle_before"] = int(probe.get(K_CYCLE))
            probe.close()
            outage["progress_at_kill"] = _progress(out)
            outage["kill_ns"] = time.monotonic_ns()
            os.killpg(cps[0].pid, 9)
            outage["cp0_rc"] = cps[0].wait()
            time.sleep(CONTROL_OUTAGE_S)
            outage["restart_ns"] = time.monotonic_ns()
            cps.append(_start_control_plane(out, "cp1", port, "--journal", journal))
            if _wait_port(port, 30.0):
                probe = StoreClient("127.0.0.1", port, timeout=10.0)
                outage["cycle_after"] = int(probe.get(K_CYCLE))
                outage["served_ns"] = time.monotonic_ns()
                probe.close()
        rc = _wait_or_kill(proc, deadline)
        if len(cps) == 2 and cps[1].poll() is None:
            # the control plane lingers after the job's success: read every
            # cycle's save-commit counters (``store_sync_fn``) from its store
            probe = StoreClient("127.0.0.1", port, timeout=10.0)
            outage["commits"] = {
                k.decode(): int(probe.get(k))
                for k in probe.list_keys(prefix="ckpt/") if b"/done_count/" in k}
            probe.close()
        cp_rcs = [outage.get("cp0_rc")] + [
            _wait_or_kill(cp, time.monotonic() + 30.0) for cp in cps[1:]]
    finally:
        for cp in cps:
            if cp.poll() is None:
                os.killpg(cp.pid, 9)
                cp.wait()
    run = _collect("(a) crash and control-plane SIGKILL", out, rc,
                   time.monotonic() - t0)
    run["cp_logs"] = [_read(os.path.join(out, f"cp{i}.log")) for i in range(len(cps))]
    run["cp_rcs"] = cp_rcs
    run["outage"] = outage
    run["ckpt_dirs"] = sorted(
        int(d[len("step"):]) for d in os.listdir(os.path.join(out, "ckpt"))
        if d.startswith("step")
        and os.path.exists(os.path.join(out, "ckpt", d, "metadata.json"))
    ) if os.path.isdir(os.path.join(out, "ckpt")) else []
    run["klog"] = klog
    print(f"control phase: (a): launcher exit {rc} after {run['wall_s']:.2f} s; "
          f"control planes exit {cp_rcs}", flush=True)
    return run


def _control_b(torch, cfg, batch_size: int, seq: int, device, root: str,
               reference: list) -> dict:
    """(b): the in-process ring over the sharded store, a shard SIGKILLed
    and its spare promoted, then an exception fault."""
    from tpu_resiliency_torch.inprocess.store_ops import InprocStore
    from tpu_resiliency_torch.store import (
        ShardMap,
        ShardedStoreClient,
        StoreClient,
        StoreTimeout,
        sharding,
        store_from_env,
    )

    out = os.path.join(root, "b")
    os.makedirs(out)
    n_shards = 3
    port = _free_port_run(n_shards + 1)
    endpoints = [f"127.0.0.1:{port + i}" for i in range(n_shards)]
    cp = _start_control_plane(out, "cp", port, "--shards", str(n_shards),
                              "--spares", "1", "--journal",
                              os.path.join(out, "cp.journal"))
    saved_env = {k: os.environ.get(k) for k in ("TPURX_STORE_SHARDS",)}
    info = {"endpoints": endpoints, "spare": f"127.0.0.1:{port + n_shards}"}
    # every routed op of this process, timed (the failover episodes ride
    # inside _routed: the longest op is the caller's wait across a failover)
    real_routed = ShardedStoreClient._routed
    ops = {"n": 0, "max_ms": 0.0, "slow": [], "errors": []}

    def timed_routed(self, idx, fn):
        t0 = time.monotonic_ns()
        try:
            return real_routed(self, idx, fn)
        except StoreTimeout:
            raise   # a caller's own deadline (the monitor thread's polls)
        except Exception as exc:
            ops["errors"].append(f"{type(exc).__name__}: {exc}")
            raise
        finally:
            ms = (time.monotonic_ns() - t0) / 1e6
            ops["n"] += 1
            ops["max_ms"] = max(ops["max_ms"], ms)
            if ms > 50.0:
                ops["slow"].append((idx, round(ms, 3)))

    def kill_shard(step: int) -> None:
        if step != CONTROL_B_KILL_STEP or "kill_ns" in info:
            return
        ring = InprocStore(None)
        key = ring.k_interruptions(0)   # the record the fault at step 10 writes
        smap = ShardMap(endpoints)
        victim = smap.shard_for(key.encode())
        keys = {}
        for i, ep in enumerate(endpoints):
            h, p = ep.rsplit(":", 1)
            c = StoreClient(h, int(p), timeout=10.0)
            keys[i] = sorted(k.decode() for k in c.list_keys(prefix="inproc/"))
            c.close()
        if victim == 0:
            # the seed holds the map; take the other shard with most ring keys
            victim = max((i for i in keys if i), key=lambda i: len(keys[i]))
        pid = next(int(d) for d in os.listdir("/proc") if d.isdigit()
                   and f"--port\0{port + victim}\0".encode()
                   in _read_bytes(f"/proc/{d}/cmdline")
                   and b"tpu_resiliency_torch.store.server" in _read_bytes(f"/proc/{d}/cmdline"))
        info.update({"victim": victim, "victim_keys": keys[victim],
                     "interruption_key": key,
                     "interruption_key_shard": smap.shard_for(key.encode()),
                     "keys_per_shard": {i: len(v) for i, v in keys.items()}})
        seed = StoreClient("127.0.0.1", port, timeout=10.0)
        info["kill_ns"] = time.monotonic_ns()
        os.kill(pid, 9)

        def watch_epoch():
            while time.monotonic_ns() - info["kill_ns"] < 60e9:
                raw = seed.try_get(sharding.SHARD_MAP_KEY)
                if raw and ShardMap.from_json(raw).epoch > 0:
                    info["epoch_ns"] = time.monotonic_ns()
                    info["map_after"] = ShardMap.from_json(raw).to_json()
                    break
                time.sleep(0.005)
            seed.close()

        info["watch"] = threading.Thread(target=watch_epoch, daemon=True)
        info["watch"].start()
        print(f"control phase: (b): SIGKILL shard {victim} (pid {pid}) before "
              f"step {step}: it holds {keys[victim]}; the interruption log "
              f"{key} routes to shard {info['interruption_key_shard']}", flush=True)

    t0 = time.monotonic()
    try:
        if not all(_wait_port(port + i, 30.0) for i in range(n_shards)):
            raise AssertionError(f"control phase (b): shards not listening:\n"
                                 f"{_read(os.path.join(out, 'cp.log'))[-3000:]}")
        seed = StoreClient("127.0.0.1", port, timeout=30.0)
        info["map_before"] = seed.get(sharding.SHARD_MAP_KEY).decode()
        seed.close()
        os.environ["TPURX_STORE_SHARDS"] = ",".join(endpoints)
        ShardedStoreClient._routed = timed_routed
        try:
            res = _wrap_run(torch, cfg, batch_size, seq, device, CONTROL_B_STEPS,
                            CONTROL_B_FAULTS, store_from_env, on_step=kill_shard)
        finally:
            ShardedStoreClient._routed = real_routed
        if "watch" in info:
            info.pop("watch").join(timeout=30.0)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        cp.terminate()
        info["cp_rc"] = _wait_or_kill(cp, time.monotonic() + 30.0)
    res["info"] = info
    res["ops"] = ops
    res["cp_log"] = _read(os.path.join(out, "cp.log"))
    res["phase_s"] = time.monotonic() - t0
    res["reference"] = reference
    return res


def _read_bytes(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return b""


def _control_c_run(root: str, two: dict, name: str, faults: bool) -> dict:
    """One run of (c): two nodes (and with ``faults`` a hot spare and the
    two Xid lines) against the port's control plane, the health loop on."""
    out = os.path.join(root, f"c_{name}")
    os.makedirs(out)
    port = _free_port_run()
    t0 = time.monotonic()
    cp = _start_control_plane(out, "cp", port, "--min-nodes", "2",
                              "--max-nodes", "2", "--settle-time",
                              str(CONTROL_C_SETTLE_S))
    nodes = ("nodeA", "nodeB", "nodeC") if faults else ("nodeA", "nodeB")
    procs, logs, marks = {}, {}, {}
    try:
        if not _wait_port(port, 30.0):
            raise AssertionError("control phase (c): no control plane")
        for node in nodes:
            logs[node] = os.path.join(out, f"{node}.kern.log")
            open(logs[node], "w").close()
            env = _ft_env(out, {
                **two, "FT_STEPS": str(CONTROL_C_STEPS),
                "FT_STEP_SLEEP": str(CONTROL_C_STEP_SLEEP_S),
                "TPURX_PROFILING_FILE": os.path.join(out, f"{node}.profiling.jsonl"),
                "TPURX_FT_MONITOR_HEALTH_CHECK_INTERVAL": str(CONTROL_HEALTH_INTERVAL_S),
                "TPURX_FT_MONITOR_HEALTH_CHECKS": CONTROL_HEALTH_CHECKS,
                "TPURX_FT_MONITOR_HEALTH_KERNEL_LOG": logs[node]})
            procs[node] = _start_launcher(out, node, env, [
                "--nnodes", "2:2", "--nproc-per-node", "1", "--node-id", node,
                "--rdzv-endpoint", f"127.0.0.1:{port}"])
            # B joins before C: B is a participant and C the hot spare
            time.sleep(1.0)
        deadline = t0 + CONTROL_RUN_TIMEOUT_S["c_faults" if faults else "c_clean"]
        if faults:
            for node, line, at in (("nodeA", CONTROL_XID_APP, CONTROL_C_XID_APP_AT),
                                   ("nodeB", CONTROL_XID_HARD, CONTROL_C_XID_HARD_AT)):
                while (_progress(out) < at and time.monotonic() < deadline
                       and procs["nodeA"].poll() is None):
                    time.sleep(0.02)
                marks[node] = time.monotonic_ns()
                with open(logs[node], "a") as f:
                    f.write(line.format(pid=os.getpid()) + "\n")
        rcs = {node: _wait_or_kill(p, deadline) for node, p in procs.items()}
        cp_rc = _wait_or_kill(cp, time.monotonic() + 30.0)
    finally:
        for p in (*procs.values(), cp):
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    run = _collect(f"(c) {name}", out, rcs.get("nodeA"), time.monotonic() - t0,
                   tags=nodes, profiling=[f"{n}.profiling.jsonl" for n in nodes])
    run.update({"rcs": rcs, "cp_rc": cp_rc, "marks": marks,
                "cp_log": _read(os.path.join(out, "cp.log")),
                "node_out": {n: _read(os.path.join(out, f"{n}.err"))
                             + _read(os.path.join(out, f"{n}.out")) for n in nodes},
                "node_profiling": {n: _jsonl(os.path.join(out, f"{n}.profiling.jsonl"))
                                   for n in nodes}})
    print(f"control phase: (c) {name}: launchers exit {rcs}, control plane "
          f"{cp_rc}, {run['wall_s']:.2f} s", flush=True)
    return run


def _control_c(root: str, two: dict) -> dict:
    """(c): the uninterrupted two-node run, then the faulted run with the
    hot spare (each its own control plane)."""
    return {name: _control_c_run(root, two, name, faults)
            for name, faults in (("clean", False), ("faults", True))}


def control_phase(torch, card: str, injob: dict, wrap: dict, cfg, batch_size: int,
                  seq: int, device=None) -> dict:
    """The job-level control plane (phase 16): the port's control plane
    process with its journal, shards and spare, the multiplexed and sharded
    store clients, and the rank monitor's passive health loop, around the
    trainer worker.  On the card with ``device=None``; ``device="cpu"``
    rehearses it on the CPU at the tiny config (the probe off, no launch
    count claimed)."""
    on_card = device is None
    dev = "cuda:0" if on_card else "cpu"
    root = tempfile.mkdtemp(prefix="tpurx_control_")
    full = {"FT_DEVICE": dev, "FT_BACKEND": "nccl" if on_card else "gloo",
            "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "1" if on_card else "0"}
    if on_card:
        full.update({"FT_CFG": "{}", "FT_BATCH": str(TRAIN_BATCH),
                     "FT_SEQ": str(TRAIN_SEQ)})
    else:
        full.update({"FT_CFG": json.dumps(INJOB_TINY), "FT_BATCH": "2",
                     "FT_SEQ": "32"})
    two = {"FT_DEVICE": dev, "FT_BACKEND": "gloo", "FT_MESH": "dp_tp",
           "FT_CFG": json.dumps(INJOB_TINY), "FT_BATCH": str(INJOB_TWO_BATCH),
           "FT_SEQ": str(INJOB_TWO_SEQ), "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "0"}
    t_phase = time.monotonic()
    # (c) runs beside (a) and (b): tiny, over gloo, its own launchers; its
    # runs are bounded by their own timeouts, so the join below returns
    c_runs = {}

    def run_c():
        try:
            c_runs.update(_control_c(root, two))
        except Exception as exc:  # noqa: BLE001 - reported by the main thread
            c_runs["error"] = exc

    c_thread = threading.Thread(target=run_c)
    c_thread.start()
    try:
        a = _control_a(root, full, injob["clean_losses"])
        host = _passive_host(a["klog"])
        b = _control_b(torch, cfg, batch_size, seq, device, root, wrap["reference"])
    finally:
        c_thread.join()
        shutil.rmtree(root, ignore_errors=True)
    if "error" in c_runs:
        raise AssertionError(f"control phase: (c) failed: {c_runs['error']!r}")
    wall_s = time.monotonic() - t_phase

    # -- (a) ------------------------------------------------------------------
    ref = injob["clean_losses"]
    fault_rows = _injob_faults(a, CONTROL_CRASH)
    cycles = _injob_cycles(a, 0)
    losses0 = a["losses"].get(0, [])
    mismatched = _bit_for_bit(ref, losses0)
    last = max((r["cycle"] for r in losses0), default=-1)
    steps_done = sorted({r["step"] for r in losses0 if r["cycle"] == last})
    ev0 = a["events"].get(0, [])
    done = [e for e in ev0 if e["event"] == "done"]
    store_ev = [e for e in ev0 if e["event"] == "store"]
    slow = [e for e in ev0 if e["event"] == "store_slow"]
    outage = a["outage"]
    worker_max_ms = max([e.get("store_max_ms", 0.0) for e in done]
                        + [e["ms"] for e in slow], default=0.0)
    across = [e for e in slow if outage.get("kill_ns") is not None
              and e["t0_ns"] + e["ms"] * 1e6 >= outage["kill_ns"]]
    ride_out_ms = ((outage["served_ns"] - outage["kill_ns"]) / 1e6
                   if "served_ns" in outage else None)
    # the restarted control plane opens the next round (the JAX package's
    # HostRoundLoop.start): the launcher stops the running worker and the
    # next cycle resumes from its last committed save
    ran = [r["step"] for r in losses0 if r["cycle"] == 1]
    ready2 = _event(a, 0, 2, "ready")
    first2 = _event(a, 0, 2, "first_step")
    stop2 = (_prof(a, "worker_stop_requested", outage["kill_ns"])
             if "kill_ns" in outage else None)
    cp_row = {"kind": "control_plane_sigkill", "cycle": 1,
              "last_step": max(ran) if ran else None,
              "restored_from": ready2 and ready2["restored_from"],
              "stop_ms": stop2 and (stop2["mono_ns"] - outage["kill_ns"]) / 1e6,
              "restart_ms": (first2["ns"] - outage["kill_ns"]) / 1e6
              if first2 and "kill_ns" in outage else None}
    if ran and ready2 and ready2["restored_from"] is not None:
        cp_row["steps_lost"] = max(ran) + 1 - ready2["restored_from"]
    health = _health_runs(a)
    health_failures = [e for e in a["profiling"]
                       if e.get("event") in ("health_failure", "node_exclude_requested")]
    quorum_trips = ([t for e in done for t in e.get("trips", [])]
                    + [e for e in a["profiling"] if e.get("event") == "failure_detected"
                       and e.get("source") == "workload_control"])
    expect_saves = list(range(0, INJOB_STEPS, INJOB_SAVE_EVERY))
    commits = outage.get("commits") or {}
    per_cycle = {}
    for k in commits:
        c, _, idx = k[len("ckpt/c"):].partition("/done_count/")
        per_cycle.setdefault(int(c), []).append(int(idx))
    worker_cycles = sorted({e["cycle"] for e in ev0})
    a_launches = {k: sum(c["launches"].get(k, 0) for c in cycles)
                  for k in ("quorum_local_max", "chunk_fingerprint",
                            "chunk_fingerprint_shards")}
    tpu_sys = host["auto"]["tpu_sys"]
    tpu_sys_count = int(tpu_sys[1].split()[0]) if tpu_sys[1][:1].isdigit() else 0
    n_cards = torch.cuda.device_count() if on_card else 0

    # -- (b) ------------------------------------------------------------------
    b_run, info, ops = b["run"], b["info"], b["ops"]
    b_mismatched = [(it, s, v, b["reference"][s]) for it, s, v in b_run["losses"]
                    if v != b["reference"][s]]
    b_faults = b_run["faults"]
    epoch_ms = ((info["epoch_ns"] - info["kill_ns"]) / 1e6
                if "epoch_ns" in info and "kill_ns" in info else None)
    map_after = json.loads(info.get("map_after") or "{}")

    # -- (c) ------------------------------------------------------------------
    c_clean, c_faults = c_runs["clean"], c_runs["faults"]
    two_ref = {r: {x["step"]: x["loss"] for x in rows}
               for r, rows in c_clean["losses"].items()}
    c_mismatched = {r: _bit_for_bit(two_ref.get(r, {}), rows)
                    for r, rows in c_faults["losses"].items()}
    prof = c_faults["node_profiling"]
    hf = next((e for e in prof.get("nodeB", []) if e.get("event") == "health_failure"), None)
    excl = next((e for e in prof.get("nodeB", [])
                 if e.get("event") == "node_exclude_requested"), None)
    xid_ms = ((hf["mono_ns"] - c_faults["marks"]["nodeB"]) / 1e6
              if hf and "nodeB" in c_faults["marks"] else None)
    spare_started = [e for e in prof.get("nodeC", [])
                     if e.get("event") == "worker_start_requested"]
    spare_cycle = spare_started[0]["cycle"] if spare_started else None
    spare_first = min((e["ns"] for evs in c_faults["events"].values() for e in evs
                       if e["event"] == "first_step" and e["cycle"] == spare_cycle),
                      default=None)
    spare_ms = ((spare_first - excl["mono_ns"]) / 1e6
                if excl is not None and spare_first is not None else None)
    a_after_xid = [e.get("healthy") for e in prof.get("nodeA", [])
                   if e.get("event") == "health_check_completed"
                   and e.get("check") == "kernel_log"
                   and e["mono_ns"] > c_faults["marks"].get("nodeA", float("inf"))]

    control_launches = {
        k: a_launches[k] + b["launches"][k]
        + sum(c["launches"].get(k, 0) for run in (c_clean, c_faults)
              for r in run["events"] for c in _injob_cycles(run, r))
        for k in ("quorum_local_max", "chunk_fingerprint", "chunk_fingerprint_shards")}

    for f in fault_rows:
        print(f"control phase: (a) crash (cycle {f['cycle']}, step {f['step']}): "
              f"detected by {f.get('detected_by')} in "
              f"{f.get('detection_ms') or float('nan'):.2f} ms; restart "
              f"{f.get('restart_ms', float('nan')):.2f} ms; restored from step "
              f"{f.get('restored_from')}, steps lost {f.get('steps_lost')} ({card})")
    for c in cycles:
        print(f"control phase: (a) cycle {c['cycle']}: spawn to first step "
              f"{c.get('spawn_to_first_step_ms', float('nan')):.1f} ms (import + CUDA "
              f"{c.get('import_cuda_ms', float('nan')):.1f}, process group "
              f"{c.get('dist_ms', float('nan')):.1f}, restore "
              f"{c.get('restore_ms') or 0.0:.1f} ms from step {c.get('restored_from')}); "
              f"kernel launches {c['launches']} ({card})")
    for p in a["probes"]:
        print(f"control phase: (a) device probe healthy={p['healthy']} "
              f"cached={p['cached']} {p['ms']:.1f} ms ({card})")
    print(f"control phase: (a) control plane SIGKILLed at progress "
          f"{outage.get('progress_at_kill')}, restarted {CONTROL_OUTAGE_S:.1f} s later; "
          f"kill to the first store op served after the restart "
          f"{ride_out_ms if ride_out_ms is None else round(ride_out_ms, 2)} ms; "
          f"kill to the worker's stop {cp_row['stop_ms']} ms and to the next "
          f"cycle's first step {cp_row['restart_ms']} ms; cycle 1 ran to step "
          f"{cp_row['last_step']}, cycle 2 restored from {cp_row['restored_from']} "
          f"(steps lost {cp_row.get('steps_lost')}); rdzv/cycle "
          f"{outage.get('cycle_before')} before the kill, {outage.get('cycle_after')} "
          f"at the first op after it; longest worker store op {worker_max_ms:.2f} ms "
          f"({len(across)} over 50 ms across the outage: "
          f"{[(e['op'], round(e['ms'], 1)) for e in across]}); clients "
          f"{[e['client'] for e in store_ev]}; commit counters {commits}; committed "
          f"saves {a['ckpt_dirs']}; launcher rejoin-window lines "
          f"{a['stderr'].count('rejoin window')} ({card})")
    print(f"control phase: (a) health loop: {len(health)} runs, "
          f"{health.count(True)} healthy, {health.count(False)} failing; "
          f"health failures {len(health_failures)}, quorum trips {len(quorum_trips)}")
    print(f"control phase: passive checks on this host (no torch: "
          f"{not host['torch_loaded']}): kernel log auto source "
          f"{host['auto:mode']}: {json.dumps(host['auto'])}")
    print(f"control phase: (b) shards {info['endpoints']}: SIGKILL shard "
          f"{info.get('victim')} -> map epoch {map_after.get('epoch')} in "
          f"{epoch_ms if epoch_ms is None else round(epoch_ms, 2)} ms "
          f"({map_after.get('endpoints')}); routed store ops {ops['n']}, longest "
          f"{ops['max_ms']:.2f} ms, over 50 ms {ops['slow']}, errors {ops['errors']}; "
          f"wrapper returned {b['ret']!r} after {b['wall_s']:.2f} s; kernel launches "
          f"{b['launches']} ({card})")
    for f in b_faults:
        print(f"control phase: (b) fault {f['kind']} (step {f['step']}): detection "
              f"{f.get('trip_ms', float('nan')):.2f} ms; restart "
              f"{f.get('restart_ms', float('nan')):.2f} ms; restored from step "
              f"{f.get('restored_from')}, steps lost {f.get('steps_lost')} ({card})")
    print(f"control phase: (c) Xid 79 to health_failure "
          f"{xid_ms if xid_ms is None else round(xid_ms, 2)} ms; exclusion to the "
          f"spare's first step {spare_ms if spare_ms is None else round(spare_ms, 2)} ms "
          f"(cycle {spare_cycle}); node A's kernel-log verdicts after Xid 43 "
          f"{a_after_xid}; wall {c_clean['wall_s']:.2f} / {c_faults['wall_s']:.2f} s")
    print(f"control phase: kernel launches in the workers {control_launches}; "
          f"phase {wall_s:.2f} s ({card})")

    claims = (
        ("(a) the launcher exits 0 after three cycles, the last to the end",
         a["rc"] == 0 and worker_cycles == [0, 1, 2] and last == 2
         and steps_done and steps_done[-1] == INJOB_STEPS - 1),
        ("(a) the crash detected and restarted", all(
            f.get("detected_by") == "failure_detected" and "restart_ms" in f
            for f in fault_rows)),
        ("(a) the control plane SIGKILLed in cycle 1, restarted from its journal, "
         "exits 0 on success",
         a["cp_rcs"][0] == -9 and len(a["cp_rcs"]) == 2 and a["cp_rcs"][1] == 0
         and "restored" in a["cp_logs"][1] and "shut down: success" in a["cp_logs"][1]),
        ("(a) the launcher rides out the outage; the restarted control plane's "
         "round restarts the worker from its last save",
         cp_row["restart_ms"] is not None and cp_row["restored_from"] is not None
         and cp_row["stop_ms"] is not None and cp_row["stop_ms"] > 0),
        ("(a) cycle numbering continues across the restart",
         outage.get("cycle_before") == 2
         and "rendezvous round 2 open (cycle 2)" in a["cp_logs"][1]
         and "round 0 open" not in a["cp_logs"][1]),
        ("(a) every loss equals the uninterrupted run's bit for bit",
         not mismatched and bool(losses0)),
        (f"(a) at most {INJOB_MAX_STEPS_LOST} steps lost to the crash", all(
            f.get("steps_lost") is not None
            and 0 <= f["steps_lost"] <= INJOB_MAX_STEPS_LOST for f in fault_rows)),
        # the outage holds the worker in the commit of the save it reached
        # (run after that save's step); the restart then loses that step too
        # when the new round stops the worker before the commit lands
        (f"(a) at most {INJOB_MAX_STEPS_LOST} + 1 steps lost to the outage's "
         "restart", cp_row.get("steps_lost") is not None
         and 0 <= cp_row["steps_lost"] <= INJOB_MAX_STEPS_LOST + 1),
        ("(a) no save commit lost or doubled",
         a["ckpt_dirs"] == expect_saves and bool(commits)
         and all(v == 1 for v in commits.values())
         and all(sorted(v) == list(range(len(v))) for v in per_cycle.values())),
        ("(a) the multiplexed client served the worker",
         [e["client"] for e in store_ev] == ["MuxStoreClient"] * len(worker_cycles)),
        ("(a) zero health failures and zero quorum trips, the loop ran",
         not health_failures and not quorum_trips and len(health) >= 10
         and all(health)),
        ("(a) tpu_sys counts the host's cards without a CUDA context",
         not host["torch_loaded"] and tpu_sys[0]
         and (not on_card or tpu_sys_count >= n_cards >= 1)),
        ("(a) kernels 1 and 2 launched in the workers", not on_card or (
            a_launches["quorum_local_max"] > 0 and a_launches["chunk_fingerprint"] > 0)),
        ("(a) kernel 2 launched once per save over the worker's owned leaves",
         not on_card or _fp_per_save((a,))),
        ("(b) a shard SIGKILLed, the spare promoted by an epoch bump",
         "kill_ns" in info and epoch_ms is not None and map_after.get("epoch") == 1
         and map_after["endpoints"][info["victim"]] == info["spare"]),
        ("(b) no caller saw a store error, the ring finished", b["ret"] == "done@1"
         and not ops["errors"] and len(b_faults) == 1 and "restore_ms" in b_faults[0]),
        ("(b) every loss equals the wrap phase's uninterrupted run's bit for bit",
         not b_mismatched and b_run["s"] == CONTROL_B_STEPS),
        (f"(b) at most {INJOB_MAX_STEPS_LOST} steps lost", all(
            0 <= f.get("steps_lost", -1) <= INJOB_MAX_STEPS_LOST for f in b_faults)),
        ("(c) the job finishes with exit 0, the spare in B's place",
         c_clean["rcs"] == {"nodeA": 0, "nodeB": 0} and c_faults["rcs"]["nodeA"] == 0
         and c_faults["rcs"]["nodeC"] == 0 and spare_cycle is not None
         and spare_cycle >= 1),
        ("(c) Xid 43 on A excludes nothing",
         "excluding this node" not in c_faults["node_out"]["nodeA"]
         and bool(a_after_xid) and all(a_after_xid)
         and not any(e.get("event") == "health_failure" for e in prof.get("nodeA", []))),
        ("(c) Xid 79 on B: health_failure, B excluded",
         hf is not None and "kernel_log" in hf.get("message", "") and excl is not None
         and "excluding this node" in c_faults["node_out"]["nodeB"]),
        ("(c) every loss equals the uninterrupted two-node run's bit for bit",
         set(c_faults["losses"]) == {0, 1}
         and all(not m for m in c_mismatched.values())
         and all(len(two_ref.get(r, {})) == CONTROL_C_STEPS for r in (0, 1))),
        (f"the phase within {CONTROL_BOUND_S:.0f} s", wall_s <= CONTROL_BOUND_S),
    )
    for claim, met in claims:
        print(f"control phase: {claim}: {'met' if met else 'NOT met'}")
    failed = [c for c, met in claims if not met]
    if failed:
        print(f"control phase: (a) launcher stderr tail:\n{a['stderr'][-4000:]}")
        for i, log in enumerate(a["cp_logs"]):
            print(f"control phase: (a) control plane {i} log tail:\n{log[-2000:]}")
        print(f"control phase: (b) control plane log tail:\n{b['cp_log'][-3000:]}")
        for run in (c_clean, c_faults):
            for n, text in run["node_out"].items():
                print(f"control phase: {run['name']} {n} tail:\n{text[-2500:]}")
        raise AssertionError(
            f"control phase: {failed} failed: (a) faults {fault_rows}, control "
            f"plane restart {cp_row}, mismatched {mismatched[:5]}, outage "
            f"{outage}, saves {a['ckpt_dirs']}, health {health[-5:]}, "
            f"failures {health_failures[:3]}, trips {quorum_trips[:3]}; (b) "
            f"faults {b_faults}, mismatched {b_mismatched[:5]}, info "
            f"{ {k: v for k, v in info.items() if k != 'victim_keys'} }; (c) mismatched "
            f"{c_mismatched}, rcs {c_faults['rcs']}")
    return {
        "a": {"faults": fault_rows, "control_plane_restart": cp_row,
              "cycles": cycles, "probes": a["probes"],
              "ride_out_ms": ride_out_ms, "worker_store_max_ms": worker_max_ms,
              "across_outage_ms": [e["ms"] for e in across],
              "cycle_before_after": [outage.get("cycle_before"), outage.get("cycle_after")],
              "commits": commits, "health_runs": len(health),
              "health_failing": health.count(False), "quorum_trips": len(quorum_trips),
              "launches": a_launches, "wall_s": a["wall_s"]},
        "passive_host": host,
        "b": {"victim": info.get("victim"), "victim_keys": info.get("victim_keys"),
              "kill_to_epoch_ms": epoch_ms, "store_ops": ops["n"],
              "store_max_ms": ops["max_ms"], "store_slow": ops["slow"],
              "faults": b_faults, "launches": b["launches"], "wall_s": b["wall_s"]},
        "c": {"xid_to_health_failure_ms": xid_ms, "exclusion_to_spare_step_ms": spare_ms,
              "spare_cycle": spare_cycle,
              "wall_s": [c_clean["wall_s"], c_faults["wall_s"]]},
        "launches": control_launches,
        "phase_s": wall_s,
    }


def _local_copies(torch, tree_leaves, tree) -> list:
    """A device copy of every leaf's local data (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    return [(t.to_local() if isinstance(t, DTensor) else t).clone()
            for t in tree_leaves(tree)]


def _restored_bit_for_bit(torch, tree_leaves, out, copies) -> bool:
    from torch.distributed.tensor import DTensor

    got = [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(out)]
    return len(got) == len(copies) and all(
        x.device == y.device and x.dtype == y.dtype and _same_bytes(torch, x, y)
        for x, y in zip(got, copies))


def mesh_expected_owned(cfg, n_opt_groups: int) -> list:
    """Owned shard entries per rank of a (2, 2) save of the train state by
    the JAX package's rule: one owner per distinct box, the lowest flat
    index.  The split leaves (embed and six matrices per layer, in each of
    params, mu, nu and master) have one box per "model" index, owned by the
    "data" = 0 ranks 0 and 1; the replicated ones (pos and the norm scales)
    and the scalar count are rank 0's; ranks 2 and 3 own nothing."""
    split = (1 + 6 * cfg.n_layers) * n_opt_groups
    replicated = (2 + 2 * cfg.n_layers) * n_opt_groups + 1
    return [split + replicated, split, 0, 0]


def mesh_phase(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """Phase 11: the dp x tp sharded step and its sharded save.  (a) a world
    of one over NCCL on a (1, 1) mesh; (b) four gloo processes sharing the
    card on a (2, 2) mesh.  ``device="cpu"`` rehearses both on the CPU
    (gloo throughout; the launch claims are waived off the card)."""
    a = mesh_world_one(torch, cfg, batch_size, seq, device)
    b = mesh_gloo_four(torch, cfg, batch_size, seq, a["losses"][:MESH_STEPS], device)
    return {"a": a, "b": b}


def mesh_world_one(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """Part (a): the sharded route on a (1, 1) mesh equals the unsharded
    route bit for bit, under the fused quorum lane; then one sharded save
    and restore."""
    import torch.distributed as dist

    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import adamw as adamw_mod
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import distributed as dist_mod
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.utils.tree import leaves

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    init_distributed(device=device)
    mesh = make_mesh(("data", "model"), (1, 1), device=device)
    root = tempfile.mkdtemp(prefix="tpurx_mesh_")
    try:
        routes = {}
        for name, m in (("unsharded", None), ("mesh", mesh)):
            params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                    device=device, mesh=m)
            routes[name] = {
                "params": params, "opt": tr.init_opt_state(params),
                "batch": tr.make_batch(cfg, batch_size, seq, seed=0,
                                       device=device, mesh=m),
                "step": tr.make_train_step(cfg, lr=1e-3, mesh=m),
            }
        trips = []
        fq = q.FusedStepQuorum(mesh, budget_ms=1000.0, identify=True, device=device,
                               on_stale=lambda age, d: trips.append((age, d)))
        routes["mesh"]["fused"] = fq.fuse(routes["mesh"]["step"])

        def run(name, n, fused=True):
            r = routes[name]
            step = r.get("fused", r["step"]) if fused else r["step"]
            out = []
            for _ in range(n):
                if name == "mesh":
                    fq.beat()
                r["params"], r["opt"], loss = step(r["params"], r["opt"], r["batch"])
                out.append(loss)
            return [float(v) for v in out]

        n_steps = WARMUP_STEPS + TIMED_STEPS
        plain = run("unsharded", n_steps)
        q.local_max.launches = 0
        q.local_max.launches_by_value = 0
        q.local_max.launches_pointer = 0
        adamw_mod.fused_adamw.launches = 0
        losses = run("mesh", n_steps)
        sync()
        fq.check_now()
        lm_launches = q.local_max.launches
        adamw_launches = adamw_mod.fused_adamw.launches
        print(f"mesh phase (a): {n_steps} steps on the (1, 1) mesh: losses "
              f"{[round(v, 4) for v in losses]}; unsharded route "
              f"{[round(v, 4) for v in plain]}; local max launches {lm_launches}; "
              f"fused AdamW launches {adamw_launches}")

        # one sharded save of the train state, restored bit for bit
        r = routes["mesh"]
        tree = tr.state_tree(r["params"], r["opt"])
        copies = _local_copies(torch, leaves, tree)
        ck = ckpt_mod.AsyncCheckpointer(delta=True, digest=True, device_digest=True)
        try:
            dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
            t0 = time.perf_counter()
            ck.async_save(tree, os.path.join(root, "a"), {"iteration": 0})
            call_ms = (time.perf_counter() - t0) * 1e3
            ck.finalize_all()
            fp_launches = dd.batch_fingerprints.launches
            fp_shards = dd.batch_fingerprints.shards
            save_ms = (time.perf_counter() - t0) * 1e3
            owned = ck.last_stage_stats["shards_owned"]
        finally:
            ck.close()
        t0 = time.perf_counter()
        out = ckpt_mod.load_checkpoint(os.path.join(root, "a"), tree, resident=False)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored = _restored_bit_for_bit(torch, leaves, out, copies)
        n_leaves = len(copies)
        print(f"mesh phase (a): save of {n_leaves} DTensor and plain leaves: "
              f"async_save {call_ms:.2f} ms, committed after {save_ms:.1f} ms, "
              f"{owned} owned shards, fingerprint launches {fp_launches} over "
              f"{fp_shards} shards; "
              f"restored in {restore_ms:.1f} ms, bit for bit: {restored}")

        # step time, in turns: the mesh step under the fused lane and bare,
        # and the unsharded step (bare)
        turns = {"mesh_fused": ("mesh", True), "mesh": ("mesh", False),
                 "unsharded": ("unsharded", False)}
        samples = {k: [] for k in turns}
        for rnd in range(MESH_TIME_ROUNDS):
            for key in (list(turns) if rnd % 2 == 0 else list(turns)[::-1]):
                sync()
                t0 = time.perf_counter()
                run(*turns[key][:1], MESH_TIME_STEPS, fused=turns[key][1])
                sync()
                samples[key].append((time.perf_counter() - t0) / MESH_TIME_STEPS * 1e3)
        step_ms = {k: sorted(v)[len(v) // 2] for k, v in samples.items()}
        print(f"mesh phase (a): step ms, median of {MESH_TIME_ROUNDS} rounds of "
              f"{MESH_TIME_STEPS} in turns: (1, 1) mesh under the fused lane "
              f"{step_ms['mesh_fused']:.2f}, (1, 1) mesh bare {step_ms['mesh']:.2f}, "
              f"unsharded {step_ms['unsharded']:.2f} (all rounds {samples})")
        for claim, met in (
            ("every loss equals the unsharded route's bit for bit", losses == plain),
            ("the losses are finite and fall",
             all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
            ("no trip", not trips),
            ("the local max launched once per fused step",
             not on_card or lm_launches == n_steps),
            ("fused AdamW launched once per sharded step on the card, never on "
             "the CPU", adamw_launches == (n_steps if on_card else 0)),
            ("the fingerprint launched once over every owned shard",
             owned == n_leaves
             and (not on_card or (fp_launches == 1 and fp_shards == owned))),
            ("the sharded save restored bit for bit", restored),
        ):
            print(f"mesh phase (a): {claim}: {'met' if met else 'NOT met'}")
            if not met:
                raise AssertionError(f"mesh phase (a): {claim} failed")
        return {"losses": losses, "unsharded_losses": plain,
                "local_max_launches": lm_launches, "adamw_launches": adamw_launches,
                "fingerprint_launches": fp_launches,
                "fingerprint_shards": fp_shards,
                "owned": owned, "leaves": n_leaves, "step_ms": step_ms,
                "step_ms_rounds": samples, "save_call_ms": call_ms,
                "save_ms": save_ms, "restore_ms": restore_ms}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        dist_mod.reset()
        torch.use_deterministic_algorithms(False)


def mesh_gloo_four(torch, cfg, batch_size: int, seq: int, a_losses: list,
                   device=None) -> dict:
    """Part (b): four exec'd children (``chip_smoke.py --mesh-child``) on a
    (2, 2) gloo mesh over the one card, committing one save over the port's
    store server run here."""
    from tpu_resiliency_torch.store import StoreServer

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    root = tempfile.mkdtemp(prefix="tpurx_mesh4_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    spec = {"root": root, "store_port": server.port, "batch": batch_size,
            "seq": seq, "steps": MESH_STEPS, "device": device,
            "cfg": {k: getattr(cfg, k) for k in (
                "vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
            "dtype": None if cfg.dtype is None else str(cfg.dtype).split(".")[-1]}
    env = dict(os.environ, CHIP_SMOKE_MESH=json.dumps(spec), OMP_NUM_THREADS="2")
    url = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", str(r),
         str(world), url],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(world)]
    outs, ranks = [], []
    try:
        deadline = time.monotonic() + MESH_CHILD_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"mesh phase (b): rank {r} did not finish in "
                                     f"{MESH_CHILD_TIMEOUT_S:.0f} s")
            outs.append(out)
            if p.returncode != 0:
                raise AssertionError(
                    f"mesh phase (b): rank {r} exited {p.returncode}:\n{out[-4000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    n_groups = 4 if ranks[0]["master"] else 3
    want = mesh_expected_owned(cfg, n_groups)
    n_leaves = ranks[0]["leaves"]
    for rk in ranks:
        print(f"mesh phase (b): rank {rk['rank']} at {rk['coord']}: losses "
              f"{[round(v, 5) for v in rk['losses']]}, step ms "
              f"{[round(v, 1) for v in rk['step_ms']]}; save: {rk['owned']} owned "
              f"and {rk['non_owned']} non-owned entries, fingerprint launches "
              f"{rk['fp_launches']} over {rk['fp_shards']} shards, committed in "
              f"{rk['save_ms']:.0f} ms; "
              f"restored bit for bit: {rk['restored']} in {rk['restore_ms']:.0f} ms")
    diffs = [abs(x - y) for rk in ranks for x, y in zip(rk["losses"], a_losses)]
    print(f"mesh phase (b): four gloo processes on one card (host-staged "
          f"collectives, not a tensor-parallel speed): wall {wall_s:.1f} s; "
          f"largest loss difference to (a)'s first {MESH_STEPS} steps "
          f"{max(diffs):.6f} (tolerance {MESH_LOSS_TOL})")
    on_card = device is None
    for claim, met in (
        ("every rank's losses are finite and fall", all(
            all(math.isfinite(v) for v in rk["losses"])
            and rk["losses"][-1] < rk["losses"][0] for rk in ranks)),
        (f"the losses agree with (a)'s within {MESH_LOSS_TOL}",
         max(diffs) <= MESH_LOSS_TOL),
        ("the owned entries are the JAX rule's for (2, 2)",
         [rk["owned"] for rk in ranks] == want
         and all(rk["owned"] + rk["non_owned"] == n_leaves
                 and rk["written"] == rk["owned"] for rk in ranks)),
        ("the fingerprint launched once over each rank's owned device shards",
         not on_card or all(rk["fp_launches"] == min(1, rk["owned"])
                            and rk["fp_shards"] == rk["owned"] for rk in ranks)),
        ("every rank restored its boxes bit for bit",
         all(rk["restored"] for rk in ranks)),
    ):
        print(f"mesh phase (b): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"mesh phase (b): {claim} failed: {ranks}")
    return {"ranks": ranks, "wall_s": wall_s, "expected_owned": want,
            "max_loss_diff": max(diffs)}


def mesh_child(rank: int, world: int, url: str) -> int:
    """Part (b)'s child: one rank of the (2, 2) gloo mesh on the card."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.parallel import dp_tp, init_distributed, make_mesh
    from tpu_resiliency_torch.store import StoreClient
    from tpu_resiliency_torch.utils.tree import leaves

    spec = json.loads(os.environ["CHIP_SMOKE_MESH"])
    device = spec["device"]
    on_card = device is None
    dev = init_distributed(init_method=url, world_size=world, rank=rank,
                           device=device, backend="gloo")
    mesh = make_mesh(("data", "model"), MESH_SHAPE, device=device)
    ax = dp_tp(mesh)
    dtype = getattr(torch, spec["dtype"]) if spec["dtype"] else None
    cfg = tr.TransformerConfig(**spec["cfg"], dtype=dtype)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=device, mesh=mesh)
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, spec["batch"], spec["seq"], seed=0, device=device,
                          mesh=mesh)
    step = tr.make_train_step(cfg, lr=1e-3, mesh=mesh)
    losses, step_ms = [], []
    for _ in range(spec["steps"]):
        sync()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)

    tree = tr.state_tree(params, opt)
    copies = _local_copies(torch, leaves, tree)
    store = StoreClient("127.0.0.1", spec["store_port"], timeout=120.0)
    ck = ckpt_mod.AsyncCheckpointer(store=store, delta=True, digest=True,
                                    device_digest=True)
    path = os.path.join(spec["root"], "state")
    try:
        dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
        t0 = time.perf_counter()
        ck.async_save(tree, path, {"iteration": 0})
        ck.finalize_all(timeout=MESH_CHILD_TIMEOUT_S)
        save_ms = (time.perf_counter() - t0) * 1e3
        fp_launches = dd.batch_fingerprints.launches
        fp_shards = dd.batch_fingerprints.shards
    finally:
        ck.close()
    dist.barrier()  # rank 0's commit lands after the others' finalize
    owned = ck.last_stage_stats["shards_owned"]
    non_owned = ck.last_stage_stats["shards_not_owned"]
    with open(os.path.join(path, f"process_{rank}.json")) as f:
        written = len(json.load(f)["shards"])
    t0 = time.perf_counter()
    out = ckpt_mod.load_checkpoint(path, tree, resident=False)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    restored = _restored_bit_for_bit(torch, leaves, out, copies)
    print(json.dumps({
        "rank": rank, "coord": [ax.dp_index, ax.tp_index], "losses": losses,
        "step_ms": step_ms, "leaves": len(copies), "master": "master" in opt,
        "owned": owned, "non_owned": non_owned, "written": written,
        "fp_launches": fp_launches, "fp_shards": fp_shards, "save_ms": save_ms,
        "restore_ms": restore_ms, "restored": restored,
    }), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ring_samples(shm_name: str, op_name: str) -> list:
    """The samples of ``op_name`` in the op-ring arena ``shm_name``, oldest
    first, read from the shared memory by the layout of
    ``native/op_ring.c`` (a 24-byte header ``magic u64, max_ops u32,
    capacity u32, n_ops u64``; per op ``write_seq u64, drops u64, name[64]``
    and ``capacity`` f32 durations, index ``seq % capacity``)."""
    import struct

    from tpu_resiliency_torch.utils.shm import attach_shm

    shm = attach_shm(shm_name)
    try:
        buf = bytes(shm.buf)
    finally:
        shm.close()
    _magic, _max_ops, cap, n_ops = struct.unpack_from("<QIIQ", buf, 0)
    slot_size = 8 + 8 + 64 + 4 * cap
    for i in range(n_ops):
        off = 24 + i * slot_size
        seq, _drops = struct.unpack_from("<QQ", buf, off)
        name = buf[off + 16:off + 80].split(b"\0", 1)[0].decode()
        if name == op_name:
            ring = struct.unpack_from(f"<{cap}f", buf, off + 80)
            return [ring[k % cap] for k in range(max(0, seq - cap), seq)]
    return []


def straggler_world_one(torch, q, tr, cfg, mesh, params, opt, batch, card: str,
                        device=None) -> tuple:
    """Phase 8, straggler (a): the flagship step through a ``Detector`` (the
    section, the always-on collector with a native arena, one step under
    ``torch.profiler``) while both quorum lanes run, the tick lane on the
    native beater with the futex tripwire.  Returns the phase's record, the
    monitor and its trip list for the native hang phase."""
    import threading

    from tpu_resiliency_torch.straggler import Detector
    from tpu_resiliency_torch.straggler.xla_profile import profiled

    on_card = device is None
    dev = params.embed.device

    def sync():
        if on_card:
            torch.cuda.synchronize()

    trips = []  # (monotonic, age ms, device, lane): the lane is the thread's
    fq = q.FusedStepQuorum(
        mesh, budget_ms=1000.0, identify=True, device=device,
        on_stale=lambda age, d: trips.append((time.monotonic(), age, d, "fused")))
    mon = q.QuorumMonitor(
        mesh, budget_ms=1000.0, interval=0.01, identify=True, device=device,
        auto_beat_interval=0.002, native_beat=True, futex_tripwire=True,
        on_stale=lambda age, d: trips.append(
            (time.monotonic(), age, d, threading.current_thread().name)))
    raw = tr.make_train_step(cfg, lr=1e-3)
    inside = []  # per call: the device time of the step, by an event pair inside

    def timed_step(p, o, b):
        if not on_card:
            t0 = time.perf_counter()
            out = raw(p, o, b)
            inside.append(time.perf_counter() - t0)
            return out
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = raw(p, o, b)
        e1.record()
        inside.append((e0, e1))
        return out

    # one throwaway capture first: the profiler's one-time start-up is not
    # the profiled step's cost
    warm_dir = tempfile.mkdtemp(prefix="tpurx_prof_warm_")
    try:
        with profiled(dev, warm_dir):
            (torch.ones(1024, device=dev) * 2).sum()
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
    det = Detector(profile_interval_s=STRAGGLER_PROFILE_INTERVAL_S, device=device)
    t_made = time.monotonic()
    det.initialize()
    step = fq.fuse(det.wrap_callables({"train_step": timed_step})["train_step"])

    q.local_max.launches = 0
    q.local_max.launches_by_value = 0
    q.local_max.launches_pointer = 0
    mon.start()
    losses, host_ms, profiled_at = [], [], None
    for i in range(STRAGGLER_STEPS):
        if i == STRAGGLER_STEPS // 2:
            # the collector's duty cycle falls due: this step is profiled
            time.sleep(max(0.0, t_made + STRAGGLER_PROFILE_INTERVAL_S + 0.05
                           - time.monotonic()))
        before = det.collector.profiled_calls
        fq.beat()
        sync()
        t0 = time.perf_counter()
        with det.detection_section("step"):
            params, opt, loss = step(params, opt, batch)
        sync()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if det.collector.profiled_calls != before:
            profiled_at = i
        losses.append(loss)
    fq.check_now()
    for _ in range(1000):
        ticks = mon.tick_count
        counts = (q.local_max.launches, q.local_max.launches_by_value,
                  q.local_max.launches_pointer)
        if ticks == mon.tick_count and counts[0] == STRAGGLER_STEPS + ticks:
            break
        time.sleep(0.0005)
    launches, by_value, pointer = counts
    det.collector.flush(timeout=60.0)
    stats = det.collector.stats()
    drops = det.collector.drops()
    samples = ring_samples(det.collector.arena.shm_name, "train_step")
    device_s = ([e0.elapsed_time(e1) / 1e3 for e0, e1 in inside] if on_card
                else list(inside))
    unprofiled = [d for i, d in enumerate(device_s) if i != profiled_at]
    kernels = {n: v for n, v in stats.items() if n.startswith("xla:")}
    capture_s = sum(sum(v) for v in det.collector.last_capture.values())
    report = det.generate_report()
    jitter_p99 = mon.native_beater.jitter_p99_us()
    healthy_trips = list(trips)

    # the step's cost with the detector and collector on and off, in turns
    det_t = Detector(device=device)
    bare = fq.fuse(raw)
    watched = fq.fuse(det_t.wrap_callables({"train_step": raw})["train_step"])

    def run_bare(p, o):
        return bare(p, o, batch)

    def run_watched(p, o):
        with det_t.detection_section("step"):
            return watched(p, o, batch)

    def turn(fn):
        """ms per step over one turn of ``fn``'s steps"""
        nonlocal params, opt
        sync()
        t0 = time.perf_counter()
        for _ in range(STRAGGLER_TIME_STEPS):
            fq.beat()
            params, opt, _ = fn(params, opt)
        sync()
        return (time.perf_counter() - t0) * 1e3 / STRAGGLER_TIME_STEPS

    turns = {"off": [], "on": []}
    for r in range(STRAGGLER_TIME_ROUNDS):
        for name in (("off", "on") if r % 2 == 0 else ("on", "off")):
            turns[name].append(turn(run_bare if name == "off" else run_watched))
    fq.check_now()
    det_t.shutdown()
    step_ms = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}

    def bare_step_ms():
        """The bare fused step's median ms, for the native hang phase to
        time once the tick lane, the beater and the tripwire are stopped."""
        ms = sorted(turn(run_bare) for _ in range(STRAGGLER_TIME_ROUNDS))
        fq.check_now()
        return ms[len(ms) // 2]

    losses = [float(v) for v in losses]
    rec = {
        "native_arena": det.collector.arena.native,
        "recorded": stats["train_step"].count, "drops": sum(drops.values()),
        "profiled_calls": det.collector.profiled_calls, "profiled_at": profiled_at,
        "profiled_step_ms": host_ms[profiled_at] if profiled_at is not None else None,
        "step_ms": host_ms, "kernel_entries": len(kernels),
        "kernels_sum_ms": capture_s * 1e3,
        "top_kernels": sorted(((n, sum(v) * 1e3) for n, v in
                               det.collector.last_capture.items()),
                              key=lambda kv: -kv[1])[:5],
        "lane_filter_misses": det.collector.lane_filter_misses,
        "launches": launches, "launches_by_value": by_value,
        "launches_pointer": pointer, "ticks": ticks,
        "jitter_p99_us": jitter_p99, "beater_flags": mon.native_beater.flags,
        "report_ranks": sorted(report.section_stats),
        "steps_in_turns_ms": step_ms, "losses": losses,
        "min_margin_ms": (min(s - d for s, d in zip(samples, unprofiled)) * 1e3
                          if len(samples) == len(unprofiled) else None),
    }
    det.shutdown()
    print(f"straggler phase (a): losses {[round(v, 4) for v in losses]}; step ms "
          f"{[round(v, 2) for v in host_ms]}; step {profiled_at} profiled in "
          f"{rec['profiled_step_ms']} ms, {len(kernels)} kernel entries, their "
          f"sum {rec['kernels_sum_ms']:.2f} ms; top {rec['top_kernels']}")
    print(f"straggler phase (a): collector recorded {rec['recorded']} steps, "
          f"{rec['drops']} drops; smallest margin of a recorded duration over "
          f"the step's event-timed device time {rec['min_margin_ms']} ms; local "
          f"max launches {launches} ({STRAGGLER_STEPS} fused steps + {ticks} "
          f"ticks), {by_value} by value")
    print(f"straggler phase (a): native beater jitter p99 {jitter_p99} us (sched "
          f"flags {mon.native_beater.flags}: bit 0 pinned, bit 1 SCHED_FIFO); step "
          f"ms in turns, detector and collector off {step_ms['off']:.3f} / on "
          f"{step_ms['on']:.3f} ({(step_ms['on'] / step_ms['off'] - 1) * 100:+.2f}%) "
          f"({card})")
    for claim, met in (
        ("the arena is native", rec["native_arena"]),
        ("exactly one step ran under the profiler", rec["profiled_calls"] == 1
         and profiled_at is not None),
        ("every other step was recorded once, with no drops",
         rec["recorded"] == STRAGGLER_STEPS - 1 and rec["drops"] == 0
         and len(samples) == STRAGGLER_STEPS - 1),
        # the ring stores f32: 2^-24 relative
        ("each recorded duration is at least its step's device time",
         len(samples) == len(unprofiled) and all(
             s >= d * (1 - 2 ** -24) for s, d in zip(samples, unprofiled))),
        ("the profiled step gave kernel entries, summing to at most its time",
         len(kernels) >= 1 and rec["lane_filter_misses"] == 0
         and profiled_at is not None
         # kernels do not nest; the CPU's ATen ops do, so off the card only
         # the entries are claimed
         and (not on_card or capture_s * 1e3 <= rec["profiled_step_ms"])),
        ("the local max launched once per fused step and per tick, by value",
         not on_card or (ticks >= 1 and launches == STRAGGLER_STEPS + ticks
                         and by_value == launches)),
        ("no lane tripped", not healthy_trips),
        ("the losses are finite and fall",
         all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("generate_report gives a one-rank report", rec["report_ranks"] == [0]),
    ):
        print(f"straggler phase (a): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"straggler phase (a): {claim} failed: {rec}")
    return rec, mon, trips, bare_step_ms


def native_hang_phase(q, mon, trips: list, device=None) -> dict:
    """Phase 9, the hang phase's native half: freeze the native beater
    under a 50 ms budget; the futex tripwire must trip within budget + 0.2 s
    and the tick lane must trip naming device 0."""
    mon.budget_ms = HANG_BUDGET_MS
    # the tripwire reads the budget at each wait, and a beat (1 ms) ends a
    # wait: let it re-arm under the new budget before the wedge
    time.sleep(0.05)
    # the tick thread counts a tick just before its launch: take the counts
    # when two reads 1 ms apart agree on launches minus ticks
    gap = None
    while True:
        ticks0, launches0 = mon.tick_count, q.local_max.launches
        if launches0 - ticks0 == gap:
            break
        gap = launches0 - ticks0
        time.sleep(0.001)
    t_freeze = time.monotonic()
    mon.native_beater.freeze()

    def first(lane):
        return next((t for t in trips if t[3].startswith(lane)), None)

    while (not first("tpurx-stamp-tripwire") or not first("tpurx-quorum")) and (
            time.monotonic() - t_freeze < 10.0):
        time.sleep(0.001)
    mon.stop()
    rec = {"local_max_launches": q.local_max.launches - launches0,
           "ticks": mon.tick_count - ticks0}
    print(f"hang phase (native): local max launches from the freeze to the "
          f"stop {rec['local_max_launches']} ({rec['ticks']} ticks)")
    for name, lane in (("futex", "tpurx-stamp-tripwire"), ("tick", "tpurx-quorum")):
        trip = first(lane)
        if trip is None:
            raise AssertionError(f"hang phase (native): the {name} lane never "
                                 f"tripped: {trips}")
        t_trip, age, dev, _ = trip
        rec[f"{name}_ms"] = (t_trip - t_freeze) * 1e3
        print(f"hang phase (native): {name} lane tripped {rec[f'{name}_ms']:.2f} ms "
              f"after the freeze, age {age:.3f} ms, device {dev}")
        if t_trip < t_freeze or dev != 0 or age <= HANG_BUDGET_MS:
            raise AssertionError(f"hang phase (native): {name} trip wrong: {trip}")
    if device is None and rec["local_max_launches"] != rec["ticks"]:
        raise AssertionError(f"hang phase (native): the local max launched "
                             f"{rec['local_max_launches']} times for {rec['ticks']} ticks")
    if rec["futex_ms"] > HANG_BUDGET_MS + 200.0:
        raise AssertionError(f"hang phase (native): the futex lane took "
                             f"{rec['futex_ms']:.1f} ms, over budget + 200 ms")
    return rec


def straggler_four(torch, cfg, batch_size: int, seq: int, device=None) -> dict:
    """Phase 12, straggler (b): four exec'd children (``chip_smoke.py
    --straggler-child``) share the card, each training the flagship under a
    ``Detector`` that gathers over the port's store server run here; rank 3
    is slow in its section and in its device work.  Rank 0's report must
    name rank 3 worst in both scores and flag it alone."""
    from tpu_resiliency_torch.store import StoreServer

    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    spec = {"batch": batch_size, "seq": seq, "device": device,
            "cfg": {k: getattr(cfg, k) for k in (
                "vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
            "dtype": None if cfg.dtype is None else str(cfg.dtype).split(".")[-1]}
    env = dict(os.environ, CHIP_SMOKE_STRAGGLER=json.dumps(spec), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--straggler-child", str(r),
         str(STRAGGLER_WORLD), str(server.port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(STRAGGLER_WORLD)]
    ranks = []
    try:
        deadline = time.monotonic() + STRAGGLER_CHILD_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"straggler phase (b): rank {r} did not finish "
                                     f"in {STRAGGLER_CHILD_TIMEOUT_S:.0f} s")
            if p.returncode != 0:
                raise AssertionError(
                    f"straggler phase (b): rank {r} exited {p.returncode}:\n"
                    f"{out[-4000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        server.stop()
    wall_s = time.perf_counter() - t0
    root = ranks[0]
    sections = {int(k): v for k, v in root["sections"].items()}
    devices = {int(k): v for k, v in root["devices"].items()}
    slow = STRAGGLER_SLOW_RANK
    for rk in ranks:
        print(f"straggler phase (b): rank {rk['rank']}: warm step {rk['t_step_ms']:.2f} "
              f"ms, {rk['n_extra']} extra matmuls, step medians by its collector "
              f"{rk['median_ms']:.2f} ms, last loss {rk['loss']:.4f}")
    print(f"straggler phase (b): rank 0's report over the store: section scores "
          f"{sections}, device scores {devices}, flagged {root['flagged']}; "
          f"op_diff(3) {root['op_diff']}; wall {wall_s:.1f} s")
    for claim, met in (
        ("rank 3 scores worst in sections", min(sections, key=sections.get) == slow),
        ("rank 3 scores worst in devices", min(devices, key=devices.get) == slow),
        ("op_diff(3) is not empty", bool(root["op_diff"])),
        ("identify_stragglers flags rank 3 alone", root["flagged"] == [slow]),
        ("the other ranks got no report", all(rk["sections"] is None
                                               for rk in ranks[1:])),
    ):
        print(f"straggler phase (b): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"straggler phase (b): {claim} failed: {ranks}")
    return {"ranks": ranks, "wall_s": wall_s, "sections": sections,
            "devices": devices, "flagged": root["flagged"]}


def straggler_child(rank: int, world: int, store_port: int) -> int:
    """Phase 12's child: one rank training the flagship under a
    Detector, in its turn; rank 3 sleeps 20 ms more in its section and runs
    bf16 matmuls worth about one step's device time inside its wrapped
    call."""
    import torch

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.store import StoreClient, barrier
    from tpu_resiliency_torch.straggler import Detector

    spec = json.loads(os.environ["CHIP_SMOKE_STRAGGLER"])
    device = spec["device"]
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    dtype = getattr(torch, spec["dtype"]) if spec["dtype"] else None
    cfg = tr.TransformerConfig(**spec["cfg"], dtype=dtype)

    def device_ms(fn, n=1):
        """ms per call of fn: CUDA events on the card, the host clock here."""
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) * 1e3 / n
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / n

    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=device)
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, spec["batch"], spec["seq"], seed=rank, device=device)
    raw = tr.make_train_step(cfg, lr=1e-3)
    width = 4096 if on_card else 128
    a = torch.randn(width, width, device=dev,
                    dtype=torch.bfloat16 if on_card else torch.float32)
    n_extra = 0

    def train_step(p, o, b):
        out = raw(p, o, b)
        if rank == STRAGGLER_SLOW_RANK:
            for _ in range(n_extra):
                a @ a
        return out

    store = StoreClient("127.0.0.1", store_port, timeout=120.0)
    det = Detector(store=store, rank=rank, world_size=world, gather_on_rank0=True,
                   device=device, report_interval=1 << 30)
    step = det.wrap_callables({"train_step": train_step})["train_step"]
    # The ranks step in turns, each while the others wait at the store: ranks
    # stepping at once on one card share its time slices and move in
    # lockstep, which no job with a card per rank does
    for turn in range(world):
        barrier(store, f"chip_smoke/straggler/turn/{turn}", world, timeout=240.0)
        if turn != rank:
            continue
        # warm-up for at least STRAGGLER_WARM_S: the card idled while the
        # processes started, and the first turn would otherwise step on
        # clocks still ramping up
        t_warm = time.perf_counter()
        while time.perf_counter() - t_warm < STRAGGLER_WARM_S:
            raw(params, opt, batch)
        t_step = device_ms(lambda: raw(params, opt, batch))
        n_extra = max(1, round(t_step / device_ms(lambda: a @ a, 10)))
        for _ in range(STRAGGLER_CHILD_STEPS):
            with det.detection_section("step"):
                if rank == STRAGGLER_SLOW_RANK:
                    time.sleep(STRAGGLER_SLOW_SLEEP_S)
                params, opt, loss = step(params, opt, batch)
        det.collector.flush(timeout=60.0)
    report = det.generate_report(timeout=240.0)
    out = {"rank": rank, "t_step_ms": t_step, "n_extra": n_extra,
           "loss": float(loss), "sections": None,
           "median_ms": det.collector.stats()["train_step"].median * 1e3}
    if report is not None:
        out.update(
            sections=report.relative_section_scores(),
            devices=report.relative_device_scores(),
            op_diff=report.op_diff(STRAGGLER_SLOW_RANK),
            flagged=[v.rank for v in report.identify_stragglers() if v.is_straggler])
    det.shutdown()
    store.close()
    print(json.dumps(out), flush=True)
    return 0


def wedge_child() -> int:
    """Phase 13's child: a small trainer under the port's Wrapper (monitor
    process on) that wedges itself in the spin kernel.  Never returns on
    the card: its monitor process kills it."""
    import signal
    import threading

    import torch

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.inprocess import (
        AbortLadder,
        AbortTorchDistributed,
        ClearCudaCaches,
        FingerprintStage,
        Wrapper,
    )
    from tpu_resiliency_torch.inprocess.fingerprint import record_dispatch
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import device_spin
    from tpu_resiliency_torch.parallel import init_distributed
    from tpu_resiliency_torch.store import StoreClient
    from tpu_resiliency_torch.straggler import OpCollector
    from tpu_resiliency_torch.utils.inject_fault import Fault, fire

    # a trainer's own SIGTERM handler (a save on preemption, say) runs only
    # at a bytecode boundary, which the wedged main thread never reaches:
    # the monitor's SIGTERM goes unanswered and its SIGKILL follows
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cfg = tr.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, max_seq=32)

    def report_launch():
        while device_spin.device_spin.launches == 0:
            time.sleep(0.001)
        print(f"wedge child: spin launches={device_spin.device_spin.launches} "
              f"launched_ns={time.time_ns()}", flush=True)

    def train(call_wrapper=None):
        if call_wrapper.iteration > 0:
            return "restarted"  # the ring must never get here
        params = tr.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        opt = tr.init_opt_state(params)
        batch = tr.make_batch(cfg, 2, 32, seed=0)
        # the steps run through the op collector, whose ring lives in shm:
        # the parent reads it while this process is wedged
        collector = OpCollector()
        step = collector.wrap(tr.make_train_step(cfg), "train_step")
        for _ in range(5):
            call_wrapper.ping()
            params, opt, loss = step(params, opt, batch)
        collector.flush(timeout=30.0)
        client = StoreClient(os.environ["TPURX_STORE_ADDR"],
                             int(os.environ["TPURX_STORE_PORT"]), timeout=30.0)
        client.set(WEDGE_OPRING_KEY, collector.arena.shm_name)
        client.close()
        print(f"wedge child: trained 5 steps, loss {float(loss):.4f}, op ring "
              f"{collector.arena.shm_name}; wedging in a device program", flush=True)
        threading.Thread(target=report_launch, daemon=True).start()
        record_dispatch("device_spin")
        fire(Fault.DEVICE_HANG)
        return "unwedged"

    wrapper = Wrapper(
        group="wedge",
        initialize=lambda state: init_distributed(),
        abort=AbortLadder(FingerprintStage(), AbortTorchDistributed(timeout=2.0),
                          ClearCudaCaches(timeout=2.0)),
        soft_timeout=WEDGE_SOFT_TIMEOUT_S, hard_timeout=WEDGE_HARD_TIMEOUT_S,
        monitor_process_interval=0.1, monitor_thread_interval=0.05,
        last_call_wait=0.05,
    )
    ret = wrapper(train)()
    print(f"wedge child: wrapper returned {ret!r}", flush=True)
    return 3


def wedge_phase(torch, np, q, dd) -> dict:
    """Phase 13: a child wedged in the spin kernel is hard-killed by its
    monitor process, and the card serves afterwards."""
    import signal

    import re

    from tpu_resiliency_torch.inprocess.attribution import InterruptionRecord
    from tpu_resiliency_torch.store import StoreClient, StoreServer, StoreTimeout
    from tpu_resiliency_torch.straggler.inspect import render
    from tpu_resiliency_torch.utils.shm import attach_shm, unlink_shm

    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    client = StoreClient("127.0.0.1", server.port, timeout=30.0)
    env = dict(os.environ, TPURX_STORE_ADDR="127.0.0.1",
               TPURX_STORE_PORT=str(server.port), TPURX_RANK="0",
               TPURX_WORLD_SIZE="1")
    key = "inproc/wedge/iter/0/interruptions"
    ring_name, ring_text, read_while_wedged = None, "", False
    t_start = time.time_ns()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--wedge-child"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE,
    )
    try:
        try:
            client.wait([key], timeout=120.0)
            t_soft = time.time_ns()
            # the child blocks in the spin kernel until its monitor kills
            # it: read its op ring from here meanwhile
            ring_name = (client.try_get(WEDGE_OPRING_KEY) or b"").decode() or None
            if ring_name:
                ring_text = render(ring_name)
                read_while_wedged = proc.poll() is None
        except StoreTimeout:
            t_soft = None
        out, _ = proc.communicate(timeout=120)
        t_exit = time.time_ns()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        if ring_name:  # the killed child could not unlink its arena
            try:
                shm = attach_shm(ring_name)
                shm.close()
                unlink_shm(shm)
            except FileNotFoundError:
                pass
    records = [InterruptionRecord.from_json(line).interruption.value
               for line in (client.try_get(key) or b"").decode().splitlines()
               if line.strip()]
    client.close()
    server.stop()
    print("wedge phase: child output:\n" + "\n".join(
        "  | " + line for line in out.strip().splitlines()[-40:]))
    launched = [line for line in out.splitlines()
                if line.startswith("wedge child: spin launches=")]
    spin_launches = int(launched[0].split("launches=")[1].split()[0]) if launched else 0
    t_launch = int(launched[0].split("launched_ns=")[1]) if launched else None
    rec = {"rc": proc.returncode, "records": records, "spin_launches": spin_launches,
           "child_wall_ms": (t_exit - t_start) / 1e6, "op_ring": ring_text,
           "op_ring_read_while_wedged": read_while_wedged}
    print("wedge phase: the wedged child's op ring, read by shm name:\n" + "\n".join(
        "  | " + line for line in ring_text.splitlines()))
    if t_launch is not None and t_soft is not None:
        rec["launch_to_soft_timeout_ms"] = (t_soft - t_launch) / 1e6
        rec["launch_to_kill_ms"] = (t_exit - t_launch) / 1e6
    # the card still serves: both kernels against their plain versions
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randint(0, 2 ** 31 - 1, (1 << 20,), dtype=torch.int32, device=dev)
    lm_ok = torch.equal(q.local_max(x), q.local_max_reference(x))
    y = torch.randn(EMBED_F32_ELEMS, device=dev)
    fp_ok = torch.equal(dd.shard_fingerprints(y),
                        dd.fingerprint_reference(y, dd.default_chunk_bytes(), True))
    torch.cuda.synchronize()
    rec["card_serves"] = bool(lm_ok and fp_ok)
    print(f"wedge phase: child exit {proc.returncode}, spin launches "
          f"{spin_launches}, interruption records {records}; spin launch to "
          f"soft timeout {rec.get('launch_to_soft_timeout_ms', float('nan')):.1f} "
          f"ms, to the kill {rec.get('launch_to_kill_ms', float('nan')):.1f} ms; "
          f"afterwards the local max and the fingerprint equal their plain "
          f"versions: {rec['card_serves']}")
    for claim, met in (
        ("the child was SIGKILLed", proc.returncode == -signal.SIGKILL),
        ("its monitor process logged the kill", "killing" in out),
        ("the ladder released the fingerprint",
         "abort ladder: fingerprint=released" in out),
        ("the records name the soft timeout", "soft_timeout" in records),
        ("the spin kernel launched once", spin_launches == 1),
        ("its op ring read 5 steps while it was wedged", read_while_wedged
         and re.search(r"^train_step\s+5\s", ring_text, re.M) is not None),
        ("the card serves afterwards", rec["card_serves"]),
    ):
        print(f"wedge phase: {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"wedge phase: {claim} failed: {rec}")
    return rec


def _restore_sources(get_registry) -> dict:
    """Bytes counted per rung of the restore ladder so far."""
    return {s: get_registry().value_of("tpurx_ckpt_restore_source_total",
                                       {"source": s})
            for s in ("local_resident", "peer_memory", "local_disk", "peer_disk")}


def _source_delta(before: dict, after: dict) -> dict:
    return {s: after[s] - before[s] for s in before if after[s] != before[s]}


def local_world_one(torch, tr, cfg, params, opt, batch, card: str,
                    device=None) -> dict:
    """Phase local (a): node-local checkpoints of the full-width train state
    in the train phase's world of one, and the global restore sourced from
    a peer's memory."""
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import (
        AsyncCheckpointer,
        load_checkpoint,
    )
    from tpu_resiliency_torch.checkpointing.async_ckpt.peer_source import (
        PeerRestoreSource,
    )
    from tpu_resiliency_torch.checkpointing.local.manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpointing.local.replication import (
        CliqueReplication,
        PeerExchange,
    )
    from tpu_resiliency_torch.store import StoreClient, StoreServer
    from tpu_resiliency_torch.telemetry import get_registry
    from tpu_resiliency_torch.utils.tree import leaves

    on_card = device is None

    def sync():
        if on_card:
            torch.cuda.synchronize()

    step = tr.make_train_step(cfg, lr=1e-3)
    root = tempfile.mkdtemp(prefix="tpurx_local1_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    clients = [StoreClient("127.0.0.1", server.port, timeout=60.0) for _ in range(3)]
    closers = []
    out = {}
    try:
        # (a) 1-3: save while two steps run, then the resident and disk rungs
        ex = PeerExchange(clients[0], 0, namespace="local_a")
        closers.append(ex)
        mgr = LocalCheckpointManager(
            os.path.join(root, "node0"), 0, 1, store=clients[0],
            replication=CliqueReplication(ex, 1, replication_factor=2))
        closers.append(mgr)
        state = tr.state_tree(params, opt)
        copies = _local_copies(torch, leaves, state)
        n_leaves = len(copies)
        nbytes = sum(c.numel() * c.element_size() for c in copies)
        sync()
        t0 = time.perf_counter()
        mgr.save(state, iteration=1, is_async=True)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(LOCAL_DRAIN_STEPS):
            params, opt, loss = step(params, opt, batch)
        sync()
        steps_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mgr.wait()
        wait_ms = (time.perf_counter() - t0) * 1e3
        blob_bytes = os.path.getsize(mgr._blob_path(1, 0))
        rungs = {}
        for rung in ("local_resident", "local_disk"):
            if rung == "local_disk":
                mgr.drop_resident()
            before = _restore_sources(get_registry)
            t0 = time.perf_counter()
            got, it = mgr.load(state)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            rungs[rung] = {"ms": ms, "iteration": it,
                           "sources": _source_delta(before, _restore_sources(get_registry)),
                           "bit_for_bit": _restored_bit_for_bit(torch, leaves, got, copies)}
            del got
        print(f"local phase (a): {n_leaves} leaves, {nbytes} B; blob {blob_bytes} B; "
              f"save {save_ms:.1f} ms of host time, then {LOCAL_DRAIN_STEPS} steps "
              f"{steps_ms:.1f} ms, wait {wait_ms:.1f} ms ({card})")
        for rung, rec in rungs.items():
            print(f"local phase (a): restore from {rung}: {rec['ms']:.1f} ms, "
                  f"sources {rec['sources']}, bit for bit {rec['bit_for_bit']} ({card})")
        out.update(leaves=n_leaves, state_bytes=nbytes, blob_bytes=blob_bytes,
                   save_ms=save_ms, steps_during_save_ms=steps_ms, wait_ms=wait_ms,
                   restore=rungs)

        # (a) 4: the global restore sourced from a peer's resident generation
        exg = [PeerExchange(clients[1 + r], r, namespace="local_g") for r in (0, 1)]
        closers.extend(exg)
        ck = AsyncCheckpointer(delta=True, digest=True, device_digest=True)
        closers.append(ck)
        g1, g2 = os.path.join(root, "g1"), os.path.join(root, "g2")
        dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
        ck.save(tr.state_tree(params, opt), g1, {"iteration": 1})
        params, opt, loss = step(params, opt, batch)
        state = tr.state_tree(params, opt)
        copies = _local_copies(torch, leaves, state)
        ck.save(state, g2, {"iteration": 2})
        fp_launches = dd.batch_fingerprints.launches
        fp_shards = dd.batch_fingerprints.shards
        src0 = PeerRestoreSource(exg[0], 0, [1]).install()  # serves resident
        src1 = PeerRestoreSource(exg[1], 1, [0]).install()  # fetches
        closers.extend([src0, src1])
        removed = 0
        for d in (g1, g2):
            for f in os.listdir(os.path.join(d, "process_0")):
                if f.endswith(".bin"):
                    os.unlink(os.path.join(d, "process_0", f))
                    removed += 1
        st = {}
        t0 = time.perf_counter()
        got = load_checkpoint(g2, state, stats=st, resident=False, peers=src1)
        sync()
        peer_ms = (time.perf_counter() - t0) * 1e3
        peer_ok = _restored_bit_for_bit(torch, leaves, got, copies)
        del got
        print(f"local phase (a): peer source: {removed} shard files removed, "
              f"restore {peer_ms:.1f} ms, bytes_peer {st.get('bytes_peer')}, "
              f"served {src0.stats['bytes_served']}, bit for bit {peer_ok}; "
              f"fingerprint launches {fp_launches} over {fp_shards} shards in 2 "
              f"saves of {n_leaves} leaves ({card})")
        out["peer_source"] = {"ms": peer_ms, "bytes_peer": st.get("bytes_peer", 0),
                              "bytes_served": src0.stats["bytes_served"],
                              "shard_files_removed": removed,
                              "bit_for_bit": peer_ok, "fp_launches": fp_launches,
                              "fp_shards": fp_shards}
    finally:
        for c in reversed(closers):
            c.close()
        for c in clients:
            c.close()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    ps = out["peer_source"]
    for claim, met in (
        ("resident restore bit for bit from local_resident",
         rungs["local_resident"]["bit_for_bit"]
         and set(rungs["local_resident"]["sources"]) == {"local_resident"}),
        ("disk restore bit for bit from local_disk",
         rungs["local_disk"]["bit_for_bit"]
         and set(rungs["local_disk"]["sources"]) == {"local_disk"}),
        ("the peer-sourced restore is bit for bit", ps["bit_for_bit"]),
        ("every peer byte was served by the peer",
         ps["bytes_peer"] > 0 and ps["bytes_peer"] == ps["bytes_served"]),
        ("the fingerprint launched once per save over every leaf",
         not on_card or (ps["fp_launches"] == 2 and ps["fp_shards"] == 2 * n_leaves)),
    ):
        print(f"local phase (a): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"local phase (a): {claim} failed: {out}")
    return out, params, opt


def local_dryrun(card: str, device=None) -> dict:
    """Phase local (b): the port's dryrun, four ranks sharing the card over
    gloo on a (2, 2) mesh; every stage asserts in every rank."""
    from tpu_resiliency_torch import dryrun

    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(LOCAL_WORLD, device=device,
                                  timeout_s=LOCAL_CHILD_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    ranks = res["ranks"]
    on_card = device is None
    print(f"local phase (b): dryrun over {LOCAL_WORLD} processes in {wall_s:.1f} s; "
          f"launches by rank {[r['launches'] for r in ranks]}; owned "
          f"{[r['owned'] for r in ranks]} ({card})")
    tokens = ("loss=", "quorum_ok", "mesh=OrderedDict({'data': 2, 'model': 2})",
              "ckpt_roundtrip_ok", "ici_replication_ok", "straggler_gather_ok")
    for claim, met in (
        ("rank 0's line carries every stage's token",
         all(t in res["summary"] for t in tokens)),
        ("kernel 1 launched once per rank in stage 2",
         not on_card or all(r["launches"]["quorum_local_max"] == 1 for r in ranks)),
        ("kernel 2 launched once in stage 3 over each rank's owned shards",
         not on_card or (all(
             r["launches"]["chunk_fingerprint"] == min(1, r["owned"])
             and r["launches"]["chunk_fingerprint_shards"] == r["owned"]
             for r in ranks) and sum(r["owned"] for r in ranks) > 0)),
    ):
        print(f"local phase (b): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"local phase (b): {claim} failed: {res}")
    return {"summary": res["summary"], "ranks": ranks, "wall_s": wall_s}


def local_four(torch, cfg, batch_size: int, seq: int, card: str,
               device=None) -> dict:
    """Phase local (c): four exec'd children (``chip_smoke.py --local-child``)
    share the card, each holding its (2, 2) box of the flagship train state;
    each saves once through ``LocalCheckpointManager`` with
    ``IciReplication`` over the gloo group (factor 2); rank 1 then loses its
    node directory and its resident copy, and every rank loads."""
    from tpu_resiliency_torch.store import StoreServer

    root = tempfile.mkdtemp(prefix="tpurx_local4_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    spec = {"root": root, "store_port": server.port, "batch": batch_size,
            "seq": seq, "device": device,
            "cfg": {k: getattr(cfg, k) for k in (
                "vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
            "dtype": None if cfg.dtype is None else str(cfg.dtype).split(".")[-1]}
    env = dict(os.environ, CHIP_SMOKE_LOCAL=json.dumps(spec), OMP_NUM_THREADS="2")
    url = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--local-child", str(r),
         str(LOCAL_WORLD), url],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(LOCAL_WORLD)]
    ranks = []
    try:
        deadline = time.monotonic() + LOCAL_CHILD_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"local phase (c): rank {r} did not finish in "
                                     f"{LOCAL_CHILD_TIMEOUT_S:.0f} s")
            if p.returncode != 0:
                raise AssertionError(
                    f"local phase (c): rank {r} exited {p.returncode}:\n{out[-4000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    for rk in ranks:
        print(f"local phase (c): rank {rk['rank']}: blob {rk['blob_bytes']} B, "
              f"replicate {rk['replicate_ms']:.1f} ms, save {rk['save_ms']:.1f} ms, "
              f"restore {rk['restore_ms']:.1f} ms from {rk['sources']}, bit for "
              f"bit {rk['restored']}, holdings {rk['holdings']} ({card})")
    print(f"local phase (c): four gloo processes on one card: wall {wall_s:.1f} s "
          f"({card})")
    lost = ranks[LOCAL_LOST_RANK]
    for claim, met in (
        ("every rank restored its boxes bit for bit", all(r["restored"] for r in ranks)),
        ("each node held its blob and its left neighbour's",
         all(r["holdings"] == {"1": sorted({r["rank"], (r["rank"] - 1) % LOCAL_WORLD})}
             for r in ranks)),
        (f"rank {LOCAL_LOST_RANK}'s blob came from peer_memory and was persisted",
         set(lost["sources"]) == {"peer_memory"} and lost["persisted"]),
        ("the other ranks restored from their resident copy",
         all(set(r["sources"]) == {"local_resident"}
             for r in ranks if r["rank"] != LOCAL_LOST_RANK)),
    ):
        print(f"local phase (c): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"local phase (c): {claim} failed: {ranks}")
    return {"ranks": ranks, "wall_s": wall_s}


def local_child(rank: int, world: int, url: str) -> int:
    """Phase local (c)'s child: one rank of the (2, 2) gloo mesh on the card."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.checkpointing.local.ici_replication import IciReplication
    from tpu_resiliency_torch.checkpointing.local.manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpointing.local.replication import PeerExchange
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.store import StoreClient
    from tpu_resiliency_torch.telemetry import get_registry
    from tpu_resiliency_torch.utils.tree import leaves

    spec = json.loads(os.environ["CHIP_SMOKE_LOCAL"])
    device = spec["device"]
    on_card = device is None
    dev = init_distributed(init_method=url, world_size=world, rank=rank,
                           device=device, backend="gloo")
    mesh = make_mesh(("data", "model"), MESH_SHAPE, device=device)
    dtype = getattr(torch, spec["dtype"]) if spec["dtype"] else None
    cfg = tr.TransformerConfig(**spec["cfg"], dtype=dtype)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=device, mesh=mesh)
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, spec["batch"], spec["seq"], seed=0, device=device,
                          mesh=mesh)
    params, opt, _ = tr.make_train_step(cfg, lr=1e-3, mesh=mesh)(params, opt, batch)
    state = tr.state_tree(params, opt)
    copies = _local_copies(torch, leaves, state)
    store = StoreClient("127.0.0.1", spec["store_port"], timeout=120.0)
    ex = PeerExchange(store, rank, namespace="local_c")
    repl = IciReplication(None, store, rank, world, replication_factor=2, exchange=ex)
    shift = {}
    replicate = repl.replicate

    def timed_replicate(blob, tag):
        t0 = time.perf_counter()
        got = replicate(blob, tag)
        shift.update(ms=(time.perf_counter() - t0) * 1e3, blob_bytes=len(blob))
        return got

    repl.replicate = timed_replicate
    mgr = LocalCheckpointManager(os.path.join(spec["root"], f"node{rank}"), rank,
                                 world, store=store, replication=repl)
    sync()
    t0 = time.perf_counter()
    mgr.save(state, iteration=1, is_async=False)
    save_ms = (time.perf_counter() - t0) * 1e3
    holdings = {str(k): v for k, v in mgr._holdings().items()}
    dist.barrier()
    if rank == LOCAL_LOST_RANK:
        mgr.drop_resident()
        shutil.rmtree(mgr.root)
    before = _restore_sources(get_registry)
    t0 = time.perf_counter()
    got, it = mgr.load(state)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    sources = _source_delta(before, _restore_sources(get_registry))
    restored = it == 1 and _restored_bit_for_bit(torch, leaves, got, copies)
    persisted = os.path.exists(mgr._blob_path(1, rank) + ".done")
    dist.barrier()  # keep serving until every rank has restored
    mgr.close()
    repl.close()
    ex.close()
    store.close()
    print(json.dumps({
        "rank": rank, "leaves": len(copies), "blob_bytes": shift["blob_bytes"],
        "replicate_ms": shift["ms"], "save_ms": save_ms, "restore_ms": restore_ms,
        "sources": sources, "restored": restored, "persisted": persisted,
        "holdings": holdings,
    }), flush=True)
    dist.destroy_process_group()
    return 0


# policy phase: the adaptive policy loop around the trainer (phase 17).
# (a) an exception POLICY_FAULT_AFTER steps into each of the first
# POLICY_FAULTS iterations of wrap's trainer; saves gated by
# TPURX_CKPT_INTERVAL_S from a long start interval; the controller ticks
# every POLICY_TICK_S and keeps POLICY_JOURNAL_KEEP journal entries; the
# cadence clamp's floor is low enough that Young/Daly sets the cadence.
# Then a short rerun with TPURX_SHRINK_MESH=1 and one exception.
POLICY_STEPS = 45
POLICY_FAULTS = 3
POLICY_FAULT_AFTER = 15
POLICY_START_INTERVAL_S = 60.0
POLICY_TICK_S = 1.0
POLICY_JOURNAL_KEEP = 2
POLICY_CADENCE_MIN_S = 0.1
POLICY_SHRINK_STEPS = 12
POLICY_SHRINK_FAULTS = {0: ("exception", 6)}
POLICY_SERIES = ("tpurx_policy_ticks", "tpurx_policy_decisions",
                 "tpurx_policy_tau_opt_s", "tpurx_policy_cadence_s",
                 "tpurx_policy_mtbf_s", "tpurx_policy_node_risk",
                 "tpurx_policy_rank_risk", "tpurx_policy_goodput_est")
# (b) predict-and-evacuate: three ranks share the card over gloo; rank
# EVAC_VICTIM's health and straggler scores ramp worse over EVAC_RAMP_ROUNDS
# steps, and it hard-faults at EVAC_DEADLINE_STEP unless evacuated first;
# the warm join runs EVAC_JOIN_AFTER steps after the evacuation
EVAC_WORLD = 3
EVAC_VICTIM = 1
EVAC_RAMP_ROUNDS = 12
EVAC_DEADLINE_STEP = 30
EVAC_JOIN_AFTER = 2
EVAC_CHILD_TIMEOUT_S = 300.0
# the stages every rank runs (no store shard is co-hosted with the victim,
# as in the JAX package's scenario, so no spare is promoted)
EVAC_STAGES = ("ckpt_ahead", "shrink")
# (c) the lock-order sanitizer: two ranks under the Wrapper at the
# flagship's width and 2 layers, rank 1 raising at step 3 of iteration 0
SANITIZE_WORLD = 2
SANITIZE_STEPS = 8
SANITIZE_FAULT_STEP = 3
SANITIZE_LAYERS = 2
SANITIZE_CHILD_TIMEOUT_S = 240.0


def _openmetrics_ok(body: str) -> bool:
    """The exposition parses as OpenMetrics text: ``# TYPE``/``# HELP``
    comments and ``name[{labels}] value`` samples, ending in ``# EOF``."""
    import re

    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+$')
    lines = body.rstrip("\n").split("\n")
    return lines[-1] == "# EOF" and all(
        line.startswith(("# TYPE ", "# HELP ")) or sample.match(line)
        for line in lines[:-1])


def _scrape(port: int) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


class _Knobs:
    """Set environment knobs for a block and put the old values back."""

    def __init__(self, **knobs):
        self.knobs = knobs
        self.saved = {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.knobs}
        os.environ.update(self.knobs)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _policy_loop(torch, cfg, batch_size: int, seq: int, device, root: str) -> dict:
    """Policy (a): wrap's trainer under the ``Wrapper`` with a standalone
    ``PolicyController`` over its ``TelemetryFeed`` ticking beside it, the
    exporter and the clock calibration on, saves gated by the cadence the
    controller sets through the runtime overrides."""
    import glob

    from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import SaveScheduler
    from tpu_resiliency_torch.policy import PolicyController, young_daly_interval
    from tpu_resiliency_torch.store import StoreClient, StoreFactory, StoreServer
    from tpu_resiliency_torch.telemetry import clock, exporter
    from tpu_resiliency_torch.utils import env

    class RecordingScheduler(SaveScheduler):
        """Records each step's save decision and each save."""

        def __init__(self, default_interval_s):
            super().__init__(default_interval_s)
            self.checks, self.saves = [], []

        def due(self, now=None):
            # the knob is read between ta and tb: a policy tick may run
            # between the two on another thread
            ta = time.monotonic()
            interval = self.interval_s()
            due = super().due(now=ta)
            self.checks.append((ta, time.monotonic(), interval, due))
            return due

        def note_saved(self, now=None):
            super().note_saved(now)
            self.saves.append(time.monotonic())

    metrics_port = _free_port()
    flight_dir = os.path.join(root, "flight")
    os.makedirs(flight_dir)
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    journal_store = StoreClient("127.0.0.1", server.port, timeout=60.0)
    ctl = PolicyController(store=journal_store, journal_keep=POLICY_JOURNAL_KEEP)
    sched = RecordingScheduler(POLICY_START_INTERVAL_S)
    decisions, scrapes, calibrated, faulted = [], [], {}, threading.Event()
    stop = threading.Event()

    def ticker():
        # the controller's hosted loop, ticked here so that each decision
        # batch is kept with the estimator snapshot it was made from
        while not stop.wait(POLICY_TICK_S):
            t0 = time.monotonic()
            acts = ctl.tick()
            if acts:
                decisions.append({"t0": t0, "t": time.monotonic(), "seq": ctl.seq,
                                  "actions": [a.to_dict() for a in acts],
                                  "estimator": ctl.estimator.snapshot()})
                if (faulted.is_set() and not scrapes
                        and any(a.kind == "set_cadence" for a in acts)):
                    # mid-run, the first decision after this run's first fault
                    scrapes.append(_scrape(metrics_port))

    def on_iteration(cw):
        if cw.iteration > 0:
            faulted.set()
        if cw.iteration == 0:
            # the wrapper's rank 0 serves the reference clock; this process
            # is rank 0, so it calibrates against it here, and its flight
            # dumps carry the offset like any other rank's
            cal = StoreClient("127.0.0.1", server.port, timeout=60.0)
            try:
                calibrated.update(clock.calibrate(cal).to_dict())
            finally:
                cal.close()

    faults = {i: ("exception", POLICY_FAULT_AFTER) for i in range(POLICY_FAULTS)}
    thread = threading.Thread(target=ticker, name="chip-smoke-policy", daemon=True)
    # earlier phases entered the wrapper without the exporter knobs: forget
    # that, so this wrapper starts the scrape endpoint the knob asks for
    exporter._env_exporters = None
    env.clear_runtime_overrides()
    try:
        with _Knobs(TPURX_POLICY="1", TPURX_METRICS_PORT=str(metrics_port),
                    TPURX_CLOCK_CAL="1", TPURX_FLIGHT_DIR=flight_dir,
                    TPURX_POLICY_CADENCE_MIN_S=str(POLICY_CADENCE_MIN_S)):
            thread.start()
            out = _wrap_run(torch, cfg, batch_size, seq, device, POLICY_STEPS,
                            faults, StoreFactory("127.0.0.1", server.port, timeout=60.0),
                            scheduler=sched, fault_offset=True,
                            on_iteration=on_iteration)
            stop.set()
            thread.join(timeout=30)
            journal = [n for n in range(1, ctl.seq + 1)
                       if journal_store.try_get(f"policy/journal/{n}") is not None]
            cap = env.POLICY_CADENCE_MAX_S.get()
    finally:
        stop.set()
        thread.join(timeout=30)
        for e in exporter._env_exporters or ():
            e.close()
        exporter._env_exporters = None
        env.clear_runtime_overrides()
        clock.set_offset(None)
        journal_store.close()
        server.stop()
    # each cadence action against Young/Daly of the snapshot it came from
    cadence = []
    for d in decisions:
        for a in d["actions"]:
            if a["kind"] == "set_cadence":
                est = d["estimator"]
                yd = young_daly_interval(est["ckpt_cost_s"], est["mtbf_s"])
                want = min(cap, max(POLICY_CADENCE_MIN_S, yd))
                cadence.append({"t0": d["t0"], "t": d["t"], "value": float(a["value"]),
                                "young_daly_s": yd, "mtbf_s": est["mtbf_s"],
                                "ckpt_cost_s": est["ckpt_cost_s"],
                                "matches": a["value"] == f"{want:.3f}"})
    # every save decision after an action used that action's cadence (the
    # trainer reads the knob at each step), and each save came at the first
    # unsaved step whose elapsed time reached it
    # (a check whose knob read overlapped the tick that applied the next
    # action may read either that action's value or the one before it)
    uses = []
    for i, c in enumerate(cadence):
        nxt = cadence[i + 1] if i + 1 < len(cadence) else None
        until = nxt["t0"] if nxt else float("inf")
        uses.append(all(abs(iv - c["value"]) < 5e-4
                        for ta, tb, iv, _ in sched.checks if c["t"] < ta and tb < until)
                    and (nxt is None or all(
                        min(abs(iv - c["value"]), abs(iv - nxt["value"])) < 5e-4
                        for ta, tb, iv, _ in sched.checks
                        if c["t"] < ta and tb >= nxt["t0"] and ta <= nxt["t"])))
    due_per_save = []
    first = cadence[0]["t"] if cadence else float("inf")
    # from the last save before the first action: the first save after it
    # may have been found due just before the action
    prev = max((ts for ts in sched.saves if ts <= first), default=float("-inf"))
    for ts in sched.saves:
        if ts > first:
            due_per_save.append(sum(1 for _, t, _, due in sched.checks
                                    if due and prev < t <= ts))
            prev = ts
    body = scrapes[0] if scrapes else ""
    mtbf = [float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
            if line.startswith("tpurx_policy_mtbf_s{")]
    return {"out": out, "decisions": decisions, "cadence": cadence, "uses": uses,
            "due_per_save": due_per_save, "saves": len(sched.saves),
            "scrape": body, "mtbf": mtbf, "journal": journal, "seq": ctl.seq,
            "dumps": sorted(glob.glob(os.path.join(flight_dir, "*.jsonl"))),
            "calibrated": calibrated}


def _episodes_rendered(dumps: list) -> dict:
    """``trace.convert`` of the flight dumps: each episode the dumps name
    and whether the trace renders a phase span of it."""
    from tpu_resiliency_torch.telemetry import trace

    named = set()
    for path in dumps:
        for rec in trace.read_jsonl(path):
            if rec.get("episode") and rec.get("event") != trace.META_EVENT:
                named.add(str(rec["episode"]))
    rendered = {str(e.get("args", {}).get("episode")) for e in
                trace.convert(dumps)["traceEvents"] if e.get("cat") == "episode"}
    return {e: e in rendered for e in sorted(named)}


def policy_phase(torch, card: str, wrap: dict, cfg, batch_size: int, seq: int,
                 device=None) -> dict:
    """Phase 17: the adaptive policy loop ((a) the per-rank loop, (b)
    predict-and-evacuate across three ranks, (c) the lock-order sanitizer)."""
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.policy import ledger
    from tpu_resiliency_torch.store import StoreFactory, StoreServer
    from tpu_resiliency_torch.utils import env

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    t_phase = time.perf_counter()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    batch = tr.make_batch(cfg, batch_size, seq, seed=0, device=device)
    plain_step = tr.make_train_step(cfg, lr=1e-3)
    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=device)
    st = {"params": params, "opt": tr.init_opt_state(params)}
    reference = []
    for _ in range(POLICY_STEPS):
        st["params"], st["opt"], loss = plain_step(st["params"], st["opt"], batch)
        reference.append(float(loss))
    del st, params
    torch.use_deterministic_algorithms(False)

    # -- (a) the per-rank loop ------------------------------------------------
    root = tempfile.mkdtemp(prefix="tpurx_policy_")
    try:
        a = _policy_loop(torch, cfg, batch_size, seq, device, root)
        episodes = _episodes_rendered(a["dumps"])
        offsets = [json.loads(open(p).readline()).get("clock_offset_ns")
                   for p in a["dumps"]]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    run, launches = a["out"]["run"], a["out"]["launches"]
    n_leaves = len(next(iter(run["saved"].values())))
    mismatched = [(it, s, v, reference[s]) for it, s, v in run["losses"]
                  if v != reference[s]]
    faults = run["faults"]
    for f in faults:
        print(f"policy phase (a): fault {f['kind']} (iteration {f['iteration']}, "
              f"step {f['step']}): detection {f.get('trip_ms', float('nan')):.2f} ms, "
              f"restart {f.get('restart_ms', float('nan')):.2f} ms, restored from "
              f"step {f.get('restored_from')}, steps lost {f.get('steps_lost')} ({card})")
    for c in a["cadence"]:
        print(f"policy phase (a): cadence -> {c['value']:.3f} s (Young/Daly "
              f"{c['young_daly_s']:.3f} s of MTBF {c['mtbf_s']} s, checkpoint "
              f"cost {c['ckpt_cost_s']:.4f} s)")
    print(f"policy phase (a): {a['saves']} saves over {len(run['losses'])} steps "
          f"run, due checks per save after the first action {a['due_per_save']}; "
          f"kernel launches {launches}; journal seq {a['seq']}, kept "
          f"{a['journal']}; MTBF gauges {a['mtbf']}; clock offset "
          f"{a['calibrated']}; dump offsets {offsets}; episodes rendered "
          f"{episodes}; wall {a['out']['wall_s']:.2f} s ({card})")
    claims = [
        ("the wrapper returned after every fault", a["out"]["ret"] == f"done@{POLICY_FAULTS}"
         and len(faults) == POLICY_FAULTS and all("restore_ms" in f for f in faults)),
        ("every loss equals the uninterrupted run's bit for bit, whose first "
         "steps are wrap's", not mismatched and run["s"] == POLICY_STEPS
         and reference[:len(wrap["reference"])] == wrap["reference"]),
        ("the scrape mid-run parses as OpenMetrics and holds every "
         "tpurx_policy_* series", bool(a["scrape"]) and _openmetrics_ok(a["scrape"])
         and all(f"# TYPE {name} " in a["scrape"] for name in POLICY_SERIES)),
        ("tpurx_policy_mtbf_s is finite after the first fault, measured from "
         "the fault rate", bool(a["mtbf"])
         and any(0 < v < env.POLICY_WINDOW_S.get() for v in a["mtbf"])),
        ("the cadence actions are Young/Daly of the estimator's own snapshot",
         bool(a["cadence"]) and all(c["matches"] for c in a["cadence"])),
        ("the trainer's save interval followed each cadence within one step",
         bool(a["uses"]) and all(a["uses"]) and bool(a["due_per_save"])
         and all(n == 1 for n in a["due_per_save"])),
        ("kernel 2 launched once per save over every leaf", not on_card
         or (launches["chunk_fingerprint"] == a["saves"]
             and launches["chunk_fingerprint_shards"] == n_leaves * a["saves"])),
        (f"the journal keeps the last {POLICY_JOURNAL_KEEP} decisions",
         a["seq"] > POLICY_JOURNAL_KEEP and a["journal"] == list(
             range(a["seq"] - POLICY_JOURNAL_KEEP + 1, a["seq"] + 1))),
        ("the flight dumps carry a clock offset", bool(a["dumps"])
         and all(o is not None for o in offsets)),
        ("trace.convert renders each episode", len(episodes) >= POLICY_FAULTS
         and all(episodes.values())),
        ("every abort stage released, the opt-in mesh shrink skipped",
         all(_ladder_released(o, shrink=False) for o in run["ladders"])),
    ]

    # -- (a) once more with TPURX_SHRINK_MESH=1 ----------------------------------
    before = ledger().stats("exception", "mesh_shrink").attempts
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    try:
        with _Knobs(TPURX_SHRINK_MESH="1"):
            shrink = _wrap_run(torch, cfg, batch_size, seq, device, POLICY_SHRINK_STEPS,
                               POLICY_SHRINK_FAULTS,
                               StoreFactory("127.0.0.1", server.port, timeout=60.0))
    finally:
        server.stop()
    srun = shrink["run"]
    shrunk = ledger().stats("exception", "mesh_shrink").attempts - before
    print(f"policy phase (a): TPURX_SHRINK_MESH=1: ladders {srun['ladders']}, "
          f"mesh_shrink episodes {shrunk}, restored from "
          f"{[f.get('restored_from') for f in srun['faults']]}, wall "
          f"{shrink['wall_s']:.2f} s ({card})")
    smis = [(it, s) for it, s, v in srun["losses"] if v != reference[s]]
    claims += [
        ("with TPURX_SHRINK_MESH=1 the episode is labelled mesh_shrink",
         shrunk == len(POLICY_SHRINK_FAULTS)
         and all(_ladder_released(o, shrink=True) for o in srun["ladders"])),
        ("with TPURX_SHRINK_MESH=1 the run restored and went on bit for bit",
         shrink["ret"] == f"done@{len(POLICY_SHRINK_FAULTS)}" and not smis
         and srun["s"] == POLICY_SHRINK_STEPS),
    ]
    for claim, met in claims:
        print(f"policy phase (a): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(
                f"policy phase (a): {claim} failed: faults {faults}, cadence "
                f"{a['cadence']}, uses {a['uses']}, due per save "
                f"{a['due_per_save']}, journal {a['journal']} of {a['seq']}, "
                f"mismatched {mismatched[:5]}, shrink {srun['ladders']} {smis}")
    a_out = {"faults": faults, "cadence": a["cadence"], "saves": a["saves"],
             "due_per_save": a["due_per_save"], "launches": launches,
             "journal": a["journal"], "seq": a["seq"], "mtbf": a["mtbf"],
             "clock_offset": a["calibrated"], "episodes": episodes,
             "wall_s": a["out"]["wall_s"],
             "shrink": {"ladders": srun["ladders"], "launches": shrink["launches"],
                        "wall_s": shrink["wall_s"]}}

    # -- (b) predict-and-evacuate, and beside it (c) the lock-order sanitizer -
    # -- (neither claims a time) ------------------------------------------------
    c_cfg = tr.TransformerConfig(**{**{k: getattr(cfg, k) for k in (
        "vocab", "d_model", "n_heads", "d_ff", "max_seq")},
        "n_layers": SANITIZE_LAYERS}, dtype=cfg.dtype)
    c_result = _beside(policy_sanitize, c_cfg, batch_size, seq, card, device=device)
    b = policy_evac(torch, cfg, batch_size, seq, card, device=device)
    c = c_result()
    wall_s = time.perf_counter() - t_phase
    print(f"policy phase: {wall_s:.1f} s ({card})")
    return {"a": a_out, "b": b, "c": c, "wall_s": wall_s,
            "launches": {
                "quorum_local_max": launches["quorum_local_max"]
                + shrink["launches"]["quorum_local_max"],
                "chunk_fingerprint": launches["chunk_fingerprint"]
                + shrink["launches"]["chunk_fingerprint"]
                + b["ckpt_ahead_launches"],
                "chunk_fingerprint_shards": launches["chunk_fingerprint_shards"]
                + shrink["launches"]["chunk_fingerprint_shards"]
                + b["ckpt_ahead_shards"]}}


def _run_children(flag: str, world: int, args: list, env: dict, timeout: float,
                  what: str) -> list:
    """Start ``world`` exec'd children (``chip_smoke.py <flag> <rank> <world>
    *args``), wait for all and return the JSON each printed last; a child
    that fails or overruns ``timeout`` fails the phase."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(world),
         *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE) for r in range(world)]
    outs, failed = [], []
    try:
        deadline = time.monotonic() + timeout
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append(f"rank {r} did not finish in {timeout:.0f} s:\n{out[-3000:]}")
                continue
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError(f"{what}: " + "\n".join(failed))
    return outs


def _cfg_spec(cfg) -> dict:
    return {"cfg": {k: getattr(cfg, k) for k in (
                "vocab", "d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
            "dtype": None if cfg.dtype is None else str(cfg.dtype).split(".")[-1]}


def _cfg_from_spec(torch, tr, spec: dict):
    dtype = getattr(torch, spec["dtype"]) if spec["dtype"] else None
    return tr.TransformerConfig(**spec["cfg"], dtype=dtype)


def policy_evac(torch, cfg, batch_size: int, seq: int, card: str,
                device=None) -> dict:
    """Policy (b): predict-and-evacuate across three ranks sharing the card
    over gloo (``chip_smoke.py --evac-child``), the JAX package's
    ``soak_launcher.py --ramp-degrade`` scenario with the flagship's state."""
    from tpu_resiliency_torch.store import StoreClient, StoreServer

    root = tempfile.mkdtemp(prefix="tpurx_evac_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    spec = {"root": root, "store_port": server.port, "batch": batch_size,
            "seq": seq, "device": device, **_cfg_spec(cfg)}
    env = dict(os.environ, CHIP_SMOKE_EVAC=json.dumps(spec), OMP_NUM_THREADS="2",
               TPURX_EVAC="1")
    t0 = time.perf_counter()
    try:
        outs = _run_children("--evac-child", EVAC_WORLD,
                             [f"tcp://127.0.0.1:{_free_port()}"], env,
                             EVAC_CHILD_TIMEOUT_S, "policy phase (b)")
        store = StoreClient("127.0.0.1", server.port, timeout=30.0)
        try:
            n = int(store.try_get("evac/seq") or 0)
            records = [json.loads(store.try_get(f"evac/{i}/record"))
                       for i in range(1, n + 1)]
        finally:
            store.close()
    finally:
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    ranks = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    ctl, victim = ranks[0], ranks[EVAC_VICTIM]
    for rk in ranks:
        print(f"policy phase (b): rank {rk['rank']}: evacuate handled at step "
              f"{rk['plan_step']}, stage ns {rk['stage_ns']}, applied batches "
              f"{rk['applied']}, restore sources {rk['sources']} in "
              f"{rk['join_ms']:.1f} ms ({card})")
    print(f"policy phase (b): controller evacuations {ctl['evacuations']} at "
          f"step {ctl['plan_step']} (deadline {EVAC_DEADLINE_STEP}), published "
          f"batches {ctl['published']}; records {records}; victim's "
          f"checkpoint-ahead kernel 2 launches {victim['ckpt_ahead_launches']} over "
          f"{victim['ckpt_ahead_shards']} shards for {victim['leaves']} leaves; "
          f"warm join {victim['warm']}; wall "
          f"{wall_s:.1f} s ({card})")
    for stage in EVAC_STAGES:
        print(f"policy phase (b): tpurx_evac_stage_ns{{stage=\"{stage}\"}} per "
              f"rank {[rk['stage_ns'].get(stage) for rk in ranks]} ({card})")
    on_card = device is None
    shrinks = [r for r in records if r.get("shrink")]
    for claim, met in (
        ("the victim was evacuated exactly once, before its hard-fault deadline",
         ctl["evacuations"] == [EVAC_VICTIM]
         and ctl["plan_step"] is not None and ctl["plan_step"] < EVAC_DEADLINE_STEP),
        ("no healthy rank was evacuated", all(
            rk["evacuated"] == [EVAC_VICTIM] for rk in ranks)),
        ("the checkpoint-ahead save launched kernel 2 once over the victim's leaves",
         not on_card or (victim["ckpt_ahead_launches"] == 1
                         and victim["ckpt_ahead_shards"] == victim["leaves"])),
        ("the evac/ record is published", bool(records) and all(
            r["victim_rank"] == EVAC_VICTIM for r in records)),
        ("the victim-scoped ladder ran on the victim alone",
         len(shrinks) == 1 and shrinks[0]["by_rank"] == EVAC_VICTIM
         and "torch_distributed=released" in shrinks[0]["shrink"]
         and "shrink_mesh=released" in shrinks[0]["shrink"]
         and all(not rk["ladder_ran"] for rk in ranks if rk["rank"] != EVAC_VICTIM)),
        ("the victim's warm join read peer memory and no disk",
         victim["warm"] and victim["sources"].get("peer_memory", 0) > 0
         and not any(victim["sources"].get(s) for s in ("local_disk", "peer_disk"))),
        ("the victim's restored state equals the state saved, bit for bit",
         victim["restored"]),
        ("the policy clients applied each published batch once", all(
            rk["applied"] == ctl["published"] and rk["repoll"] == 0
            for rk in ranks if rk["rank"] != 0)),
        ("tpurx_evac_stage_ns observed each stage on every rank", all(
            set(rk["stage_ns"]) == set(EVAC_STAGES) for rk in ranks)),
    ):
        print(f"policy phase (b): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"policy phase (b): {claim} failed: {ranks} {records}")
    return {"ranks": ranks, "records": records, "wall_s": wall_s,
            "ckpt_ahead_launches": victim["ckpt_ahead_launches"],
            "ckpt_ahead_shards": victim["ckpt_ahead_shards"]}


def evac_child(rank: int, world: int, url: str) -> int:
    """Policy (b)'s child: one rank of the ramp-degrade scenario."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.checkpointing.local.manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpointing.local.replication import (
        CliqueReplication,
        PeerExchange,
    )
    from tpu_resiliency_torch.fault_tolerance.control_plane import PolicyClient
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.parallel import init_distributed
    from tpu_resiliency_torch.policy import (
        EvacuationPipeline,
        PolicyController,
        SnapshotFeed,
        set_evacuation_handler,
    )
    from tpu_resiliency_torch.soak.ramp import publish_ramp
    from tpu_resiliency_torch.store import StoreClient
    from tpu_resiliency_torch.store.barrier import barrier
    from tpu_resiliency_torch.telemetry import get_registry
    from tpu_resiliency_torch.telemetry.aggregate import (
        CrossRankAggregator,
        read_latest_snapshots,
    )
    from tpu_resiliency_torch.utils.tree import leaves

    spec = json.loads(os.environ["CHIP_SMOKE_EVAC"])
    device = spec["device"]
    on_card = device is None
    dev = init_distributed(init_method=url, world_size=world, rank=rank,
                           device=device, backend="gloo")
    cfg = _cfg_from_spec(torch, tr, spec)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=device)
    st = {"params": params, "opt": tr.init_opt_state(params)}
    batch = tr.make_batch(cfg, spec["batch"], spec["seq"], seed=rank, device=device)
    train_step = tr.make_train_step(cfg, lr=1e-3)
    store = StoreClient("127.0.0.1", spec["store_port"], timeout=120.0)
    ex = PeerExchange(store, rank, namespace="evac")
    repl = CliqueReplication(ex, world, replication_factor=2)
    mgr = LocalCheckpointManager(os.path.join(spec["root"], f"n{rank}"), rank, world,
                                 store=store, replication=repl, peer_timeout=60.0)
    agg = CrossRankAggregator(store, rank, world)
    reg = get_registry()
    # the victim's own global save of its state, committed alone
    ck = ckpt_mod.AsyncCheckpointer(rank=0, world_size=1, process_index=0, delta=True,
                                    device_digest=True) if rank == EVAC_VICTIM else None
    saved = {}
    box = {"step": 0, "plan": None, "evacuated": []}

    def save_ahead():
        """Checkpoint-ahead: the state of this step, peer-held through the
        local manager; the victim also saves it globally, fingerprinted on
        the device."""
        tree = tr.state_tree(st["params"], st["opt"])
        saved["copies"] = [t.clone() for t in leaves(tree)]
        saved["iteration"] = box["step"]
        if ck is not None:
            dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
            ck.async_save(tree, os.path.join(spec["root"], "ahead"),
                          {"step": box["step"]})
            ck.maybe_finalize(blocking=True)
            saved["launches"] = dd.batch_fingerprints.launches
            saved["shards"] = dd.batch_fingerprints.shards
        mgr.save(tree, iteration=box["step"], is_async=False)

    pipe = EvacuationPipeline(store=store, rank=rank, save_fn=save_ahead)

    def on_evacuate(victim_rank, reason):
        # every rank's side of the pipeline runs from its own loop, at the
        # step all ranks learn of the decision
        box["evacuated"].append(int(victim_rank))
        if box["plan"] is None:
            box["plan"] = {"victim": int(victim_rank), "step": box["step"],
                           "reason": reason}

    set_evacuation_handler(on_evacuate)
    ctl = (PolicyController(feed=SnapshotFeed(lambda: read_latest_snapshots(store)),
                            store=store) if rank == 0 else None)
    client = PolicyClient(store) if rank != 0 else None
    published, applied = [], []
    joined, record, ladder_ran = None, None, False
    for step in range(EVAC_DEADLINE_STEP + EVAC_JOIN_AFTER + 1):
        box["step"] = step
        st["params"], st["opt"], _ = train_step(st["params"], st["opt"], batch)
        sync()
        # the ramping degradation (the soak's --ramp-degrade ramp)
        publish_ramp(reg, rank, world, step, EVAC_VICTIM, EVAC_RAMP_ROUNDS, "evac_ramp")
        agg.round(reg, timeout=60.0)
        if ctl is not None:
            if ctl.tick():
                published.append(ctl.seq)
        # the step's batch is published before anyone polls (a store barrier:
        # the victim's own process groups go with its evacuation)
        barrier(store, f"chip_smoke/evac/step{step}", world, timeout=120.0)
        if client is not None:
            before = client.applied_seq
            if client.poll_once() and client.applied_seq != before:
                applied.append(client.applied_seq)
        plan = box["plan"]
        if plan is not None and record is None:
            record = pipe.evacuate(plan["victim"], reason=plan["reason"])
            ladder_ran = record.get("shrink") is not None
        if plan is not None and step >= plan["step"] + EVAC_JOIN_AFTER:
            # the handoff: the evacuated slot drops its resident copy and its
            # node directory, so its bytes must come off peer holders'
            # memory; the holders load with it (the restore is collective)
            before = _restore_sources(get_registry)
            template = tr.state_tree(st["params"], st["opt"])
            if rank == plan["victim"]:
                mgr.drop_resident()
                shutil.rmtree(mgr.root, ignore_errors=True)
                joined = pipe.warm_join(mgr, template, iteration=saved["iteration"])
                got = joined["tree"]
            else:
                got, _ = mgr.load(template, iteration=saved["iteration"])
            sync()
            sources = _source_delta(before, _restore_sources(get_registry))
            restored = _restored_bit_for_bit(torch, leaves, got, saved["copies"])
            break
        if plan is None and rank == EVAC_VICTIM and step >= EVAC_DEADLINE_STEP:
            print(f"evac child {rank}: HARD FAULT at step {step}", flush=True)
            return 41
    else:
        print(f"evac child {rank}: no evacuation by step {step}", flush=True)
        return 42
    # keep serving until every rank has restored
    barrier(store, "chip_smoke/evac/done", world, timeout=120.0)
    repoll = client.poll_once() if client is not None else 0
    stage = reg.get("tpurx_evac_stage_ns")
    stage_ns = {labels["stage"]: v["sum"] for labels, v in stage._sample_rows()
                if v["count"]} if stage is not None else {}
    evacuations = []
    if ctl is not None:
        evacuations = [int(r["target"].split(":", 1)[1]) for r in ctl.journal
                       if r["kind"] == "evacuate"]
    print(json.dumps({
        "rank": rank, "plan_step": box["plan"]["step"], "evacuated": box["evacuated"],
        "evacuations": evacuations, "published": published, "applied": applied,
        "repoll": repoll, "stage_ns": stage_ns, "ladder_ran": ladder_ran,
        "leaves": len(saved["copies"]), "ckpt_ahead_launches": saved.get("launches", 0),
        "ckpt_ahead_shards": saved.get("shards", 0),
        "sources": sources, "restored": restored,
        "warm": bool(joined and joined["warm"]),
        "join_ms": joined["dur_ms"] if joined else 0.0,
    }), flush=True)
    set_evacuation_handler(None)
    if ck is not None:
        ck.close()
    mgr.close()
    ex.close()
    store.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def policy_sanitize(cfg, batch_size: int, seq: int, card: str, device=None) -> dict:
    """Policy (c): two exec'd children (``chip_smoke.py --sanitize-child``)
    share the card over gloo under the port's ``Wrapper`` with
    ``TPURX_SANITIZE=1`` and a witness path; rank 1 raises at step 3 of
    iteration 0, and the ring restarts both.  The port's counterpart of the
    JAX package's ``test_abort_ladder_under_lock_order_sanitizer_clean_witness``,
    held to its assertions."""
    import glob

    import torch.distributed as dist

    from tpu_resiliency_torch.store import StoreServer

    root = tempfile.mkdtemp(prefix="tpurx_sanitize_")
    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    torch_port = _free_port()
    # the c10d store each iteration's gloo world is built over, hosted here
    tcp = dist.TCPStore("127.0.0.1", torch_port, world_size=-1, is_master=True,
                        wait_for_workers=False)
    spec = {"store_port": server.port, "torch_port": torch_port, "batch": batch_size,
            "seq": seq, "device": device, **_cfg_spec(cfg)}
    env = dict(os.environ, CHIP_SMOKE_SANITIZE=json.dumps(spec), OMP_NUM_THREADS="2",
               TPURX_SANITIZE="1",
               TPURX_SANITIZE_WITNESS_PATH=os.path.join(root, "witness.r%r.p%p.jsonl"))
    t0 = time.perf_counter()
    try:
        outs = _run_children("--sanitize-child", SANITIZE_WORLD, [], env,
                             SANITIZE_CHILD_TIMEOUT_S, "policy phase (c)")
        wall_s = time.perf_counter() - t0
        paths = sorted(glob.glob(os.path.join(root, "witness.r*.jsonl")))
        edges, cycles = 0, []
        for path in paths:
            for line in open(path):
                rec = json.loads(line)
                if rec["event"] == "cycle":
                    cycles.append(rec)
                elif rec["event"] == "edge":
                    edges += 1
        # the witness files feed the static lock-order rule back: read them
        # with the repository's linter, as `tpurx-lint --witness` does
        lint = subprocess.run(
            [sys.executable, "-m", "tpurx_lint", "--rule", "TPURX011",
             "--format", "json", "--no-baseline", "--jobs", "1",
             *[a for p in paths for a in ("--witness", p)],
             os.path.join("tpu_resiliency_torch", "utils", "sanitize.py")],
            cwd=HERE, capture_output=True, text=True, timeout=120)
    finally:
        del tcp
        server.stop()
        shutil.rmtree(root, ignore_errors=True)
    blob = "".join(outs)
    rets = blob.count("ret=done@1")
    print(f"policy phase (c): two ranks under TPURX_SANITIZE=1: {rets} x "
          f"ret=done@1, {len(paths)} witness files, {edges} edges, "
          f"{len(cycles)} cycles; tpurx-lint --witness exit {lint.returncode}; "
          f"wall {wall_s:.1f} s ({card})")
    for claim, met in (
        ("both ranks recovered in process (two ret=done@1)", rets == SANITIZE_WORLD),
        ("the abort ladder ran", "abort ladder:" in blob),
        ("the sanitizer recorded no lock-order cycle", bool(paths) and not cycles),
        ("the sanitizer observed lock acquisitions", edges > 0),
        ("tpurx-lint reads the witness files",
         lint.returncode == 0 and "findings" in lint.stdout),
    ):
        print(f"policy phase (c): {claim}: {'met' if met else 'NOT met'}")
        if not met:
            raise AssertionError(f"policy phase (c): {claim} failed: cycles "
                                 f"{cycles[:3]}, lint {lint.stdout[-500:]} "
                                 f"{lint.stderr[-1000:]}\n{blob[-3000:]}")
    return {"rets": rets, "witness_files": len(paths), "edges": edges,
            "cycles": len(cycles), "wall_s": wall_s}


def sanitize_child(rank: int, world: int) -> int:
    """Policy (c)'s child: one rank of a gloo world under the ``Wrapper``,
    with the lock-order sanitizer installed by the package's import."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from tpu_resiliency_torch.inprocess import Wrapper
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.parallel import init_distributed
    from tpu_resiliency_torch.store import StoreFactory
    from tpu_resiliency_torch.utils import sanitize

    spec = json.loads(os.environ["CHIP_SMOKE_SANITIZE"])
    device = spec["device"]
    os.environ["TPURX_RANK"], os.environ["TPURX_WORLD_SIZE"] = str(rank), str(world)
    if not sanitize.stats()["installed"]:
        print("sanitize child: the sanitizer is not installed", flush=True)
        return 3
    cfg = _cfg_from_spec(torch, tr, spec)
    tcp = dist.TCPStore("127.0.0.1", spec["torch_port"], is_master=False,
                        timeout=datetime.timedelta(seconds=60))

    def initialize(state):
        init_distributed(world_size=state.active_world_size, rank=state.active_rank,
                         device=device, backend="gloo",
                         store=dist.PrefixStore(f"sanitize/it{state.iteration}", tcp))

    @Wrapper(store_factory=StoreFactory("127.0.0.1", spec["store_port"], timeout=60.0),
             initialize=initialize, soft_timeout=60.0, hard_timeout=120.0,
             monitor_process_interval=0.2, monitor_thread_interval=0.1,
             barrier_timeout=120.0, max_iterations=3)
    def train(call_wrapper=None):
        it = call_wrapper.iteration
        dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
            else torch.device("cpu")
        params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=device)
        opt = tr.init_opt_state(params)
        batch = tr.make_batch(cfg, spec["batch"], spec["seq"], seed=rank, device=device)
        step = tr.make_train_step(cfg, lr=1e-3)
        for s in range(SANITIZE_STEPS):
            call_wrapper.ping()
            if it == 0 and rank == 1 and s == SANITIZE_FAULT_STEP:
                raise RuntimeError(f"injected exception at step {s}")
            params, opt, loss = step(params, opt, batch)
            total = loss.detach().float().cpu().reshape(1)
            dist.all_reduce(total)
            if not math.isfinite(float(total)):
                raise AssertionError(f"loss not finite: {float(total)}")
        return f"done@{it}"

    ret = train()
    print(f"RESULT rank={rank} ret={ret}", flush=True)
    print(json.dumps({"rank": rank, "ret": ret, "sanitizer": sanitize.stats()}),
          flush=True)
    return 0


# attrib phase: the attribution gate, the fleet services and DCP interop
ATTRIB_FAULTS = {0: ("crash", 6, 0), 1: ("cuda_oom", 6, 0)}
ATTRIB_BOUND_S = 180.0
ATTRIB_RUN_TIMEOUT_S = 150.0
ATTRIB_SERVICE_TIMEOUT_S = 30.0
ATTRIB_FLAGSHIP_LEAVES, ATTRIB_FLAGSHIP_BYTES = 141, 412_941_316
_GATE_LINE = re.compile(
    r"attribution( \(service\))?: category=(\S+) resume=(True|False) "
    r"confidence=([0-9.]+) ranks=\[([0-9, ]*)\] in ([0-9.]+) ms")


def _gate_verdicts(stderr: str) -> list:
    """The launcher's attribution gate lines, in order."""
    return [{"service": m.group(1) is not None, "category": m.group(2),
             "should_resume": m.group(3) == "True",
             "confidence": float(m.group(4)),
             "culprit_ranks": [int(r) for r in m.group(5).split(",") if r.strip()],
             "gate_ms": float(m.group(6))}
            for m in _GATE_LINE.finditer(stderr)]


def _http(url: str, payload=None, timeout: float = 30.0):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _serve(module: str, args: list, port: int, out: str, tag: str) -> subprocess.Popen:
    """``python -m <module>`` of the port, logging to ``<tag>.err``, once
    its ``/health`` answers."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPURX_", "FT_", "CHIP_SMOKE"))}
    with open(os.path.join(out, f"{tag}.err"), "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "--host", "127.0.0.1", "--port",
             str(port), *args], cwd=HERE, env=env, stdout=subprocess.DEVNULL,
            stderr=fe)
    deadline = time.monotonic() + ATTRIB_SERVICE_TIMEOUT_S
    while time.monotonic() < deadline:
        try:
            if _http(f"http://127.0.0.1:{port}/health", timeout=2.0):
                return proc
        except OSError:
            time.sleep(0.1)
    proc.kill()
    proc.wait()
    raise AssertionError(f"attrib phase: {module} did not serve /health: "
                         f"{_read(os.path.join(out, f'{tag}.err'))[-2000:]}")


def _attrib_fleet(out: str, cycles: str, logs: str) -> dict:
    """(b): the port's attrsvc and smonsvc as processes over (a)'s
    directories, then the MCP server over stdio."""
    aport, sport = _free_port(), _free_port()
    procs = []
    try:
        procs.append(_serve("tpu_resiliency_torch.services.attrsvc", [], aport,
                            out, "attrsvc"))
        procs.append(_serve("tpu_resiliency_torch.services.smonsvc", [
            "--cycle-info-dir", cycles, "--log-dir", logs,
            "--attrsvc", f"http://127.0.0.1:{aport}", "--poll-interval", "0.2"],
            sport, out, "smonsvc"))
        smon = f"http://127.0.0.1:{sport}"
        deadline = time.monotonic() + ATTRIB_SERVICE_TIMEOUT_S
        status = _http(smon + "/status")
        while (status["totals"]["logs_submitted"] < len(ATTRIB_FAULTS)
               and time.monotonic() < deadline):
            time.sleep(0.2)
            status = _http(smon + "/status")
        jobs = _http(smon + "/jobs")
        # the cycle-1 log through the engine, with cycle 1's progress marker
        # (rank 0 at its last step, stamped when the cycle ended)
        with open(os.path.join(cycles, "cycle_info.job.1.json")) as f:
            info1 = json.load(f)
        markers = {"0": {"rank": 0, "iteration": 1, "step": ATTRIB_FAULTS[1][1],
                         "phase": "step", "ts": info1["ended_at"]}}
        job = _http(f"http://127.0.0.1:{aport}/submit",
                    {"path": os.path.join(logs, "cycle_1.log"), "markers": markers})
        submitted = _http(f"http://127.0.0.1:{aport}/result/{job['job_id']}?wait=30",
                          timeout=40.0)
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=10)
    # the CLI's monitor keeps a failed job RUNNING until its 600 s idle
    # threshold passes (no CLI flag sets it); a JobMonitor over the same
    # directories with a threshold of 0 shows the state it then reaches
    from tpu_resiliency_torch.services.smonsvc import DirectoryScheduler, JobMonitor

    idle = JobMonitor(DirectoryScheduler(cycles, logs), idle_threshold=0.0)
    idle.poll_once()
    reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize"},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
                "name": "analyze_log",
                "arguments": {"path": os.path.join(logs, "cycle_1.log")}}}]
    mcp = subprocess.run(
        [sys.executable, "-m", "tpu_resiliency_torch.attribution.mcp_server"],
        input="".join(json.dumps(r) + "\n" for r in reqs), capture_output=True,
        text=True, timeout=ATTRIB_SERVICE_TIMEOUT_S, cwd=HERE)
    resps = [json.loads(line) for line in mcp.stdout.splitlines() if line.strip()]
    tools = next((r["result"]["tools"] for r in resps if r.get("id") == 2), [])
    call = next((r["result"] for r in resps if r.get("id") == 3), None)
    return {"status": status, "jobs": jobs, "submitted": submitted,
            "state_past_idle": idle.jobs_payload()[0]["state"],
            "mcp": {"rc": mcp.returncode, "ids": [r.get("id") for r in resps],
                    "tools": sorted(t["name"] for t in tools),
                    "analyze_log": json.loads(call["content"][0]["text"])
                    if call and not call["isError"] else call}}


def _attrib_dcp(torch, cfg, batch_size: int, seq: int, device, root: str) -> dict:
    """(c): the flagship's train state (one step from the seed-0 weights)
    through ``DcpCompatCheckpointer``, ``load_dcp_checkpoint`` and
    ``migrate_to_tpurx``, each restore compared bit for bit."""
    from tpu_resiliency_torch.checkpointing import dcp_compat
    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.utils.tree import flatten, unflatten

    on_card = device is None
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    params = tr.init_params(cfg, torch.Generator(dev).manual_seed(0), device=device)
    opt = tr.init_opt_state(params)
    params, opt, _ = tr.make_train_step(cfg, lr=1e-3)(
        params, opt, tr.make_batch(cfg, batch_size, seq, seed=0, device=device))
    tree = tr.state_tree(params, opt)
    leaves, treedef = flatten(tree)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)

    def blank():
        return unflatten(treedef, [torch.empty_like(t) for t in leaves])

    def same(out):
        return all(_same_bytes(torch, a, b) for a, b in zip(flatten(out)[0], leaves))

    ck = dcp_compat.DcpCompatCheckpointer()
    try:
        sync()
        t0 = time.perf_counter()
        ck.save(tree, os.path.join(root, "dcp"))
        save_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ck.close()
    template = blank()
    live = flatten(template)[0][0]
    t0 = time.perf_counter()
    loaded = dcp_compat.load_dcp_checkpoint(os.path.join(root, "dcp"), template)
    sync()
    load_ms = (time.perf_counter() - t0) * 1e3
    dcp_same = same(loaded) and flatten(loaded)[0][0] is live
    # the knob, not migrate_to_tpurx's default AsyncCheckpointer(), turns
    # the device fingerprint on
    saved_knob = os.environ.get("TPURX_CKPT_DEVICE_DIGEST")
    os.environ["TPURX_CKPT_DEVICE_DIGEST"] = "1"
    dd.batch_fingerprints.launches = dd.batch_fingerprints.shards = 0
    try:
        t0 = time.perf_counter()
        dcp_compat.migrate_to_tpurx(os.path.join(root, "dcp"),
                                    os.path.join(root, "tpurx"), blank())
        migrate_ms = (time.perf_counter() - t0) * 1e3
        fp_launches = dd.batch_fingerprints.launches
        fp_shards = dd.batch_fingerprints.shards
    finally:
        if saved_knob is None:
            os.environ.pop("TPURX_CKPT_DEVICE_DIGEST", None)
        else:
            os.environ["TPURX_CKPT_DEVICE_DIGEST"] = saved_knob
    t0 = time.perf_counter()
    restored = ckpt_mod.load_checkpoint(os.path.join(root, "tpurx"), blank(),
                                        resident=False)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    return {"leaves": len(leaves), "bytes": nbytes, "save_ms": save_ms,
            "load_ms": load_ms, "migrate_ms": migrate_ms, "restore_ms": restore_ms,
            "dcp_bit_for_bit": dcp_same, "migrated_bit_for_bit": same(restored),
            "fp_launches": fp_launches, "fp_shards": fp_shards}


def attrib_phase(torch, card: str, injob: dict, cfg, batch_size: int, seq: int,
                 device=None) -> dict:
    """Phase 18: the attribution gate through the spawned port attrsvc
    around the flagship worker ((a)), the fleet services over its
    directories ((b)) and DCP interop at full width ((c)).  On the card with
    ``device=None``; ``device="cpu"`` rehearses it at the tiny config (the
    worker's ``cuda_oom`` then raises the error without exhausting a card,
    and no launch count is claimed)."""
    on_card = device is None
    dev = "cuda:0" if on_card else "cpu"
    root = tempfile.mkdtemp(prefix="tpurx_attrib_")
    out, cycles, logs = (os.path.join(root, d) for d in ("run", "cycles", "logs"))
    t_phase = time.monotonic()
    if on_card:
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(0)
        # the worker's allocations must cross the logger's fraction with
        # room to spare on a card this process still shares
        warn = 0.5 * free / total
        print(f"attrib phase: card memory free {free / 1e9:.2f} of "
              f"{total / 1e9:.2f} GB; the worker's warn fraction {warn:.4f} ({card})")
    else:
        warn = 0.92
    env = {"FT_DEVICE": dev, "FT_BACKEND": "nccl" if on_card else "gloo",
           "FT_STEPS": str(INJOB_STEPS), "FT_CALLBACKS": "1",
           "FT_MEM_WARN_FRACTION": repr(warn),
           "FT_FAULTS": json.dumps({str(c): list(v) for c, v in ATTRIB_FAULTS.items()}),
           "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "1" if on_card else "0",
           "TPURX_FT_ENABLE_ATTRIBUTION_GATE": "1",
           "TPURX_FT_ATTRIBUTION_SERVICE_MODE": "spawn",
           "TPURX_FT_PER_CYCLE_LOG_DIR": logs, "TPURX_FT_CYCLE_INFO_DIR": cycles}
    if on_card:
        env.update({"FT_CFG": "{}", "FT_BATCH": str(TRAIN_BATCH),
                    "FT_SEQ": str(TRAIN_SEQ)})
    else:
        env.update({"FT_CFG": json.dumps(INJOB_TINY), "FT_BATCH": "2", "FT_SEQ": "32"})
    try:
        # -- (a) the gate, through the spawned service -----------------------
        run = _launch("(a) crash, then a CUDA OOM, under the gate", out, 1, env,
                      ATTRIB_RUN_TIMEOUT_S)
        gate = _gate_verdicts(run["stderr"])
        log1 = _read(os.path.join(logs, "cycle_1.log"))
        t_b = time.monotonic()
        fleet = _attrib_fleet(out, cycles, logs)
        fleet_s = time.monotonic() - t_b
        t_c = time.monotonic()
        dcp = _attrib_dcp(torch, cfg, batch_size, seq, device, root)
        dcp_s = time.monotonic() - t_c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.monotonic() - t_phase

    ref = injob["clean_losses"]
    losses = run["losses"].get(0, [])
    mismatched = _bit_for_bit(ref, losses)
    by_cycle = {c: sorted(r["step"] for r in losses if r["cycle"] == c) for c in (0, 1)}
    started = sorted(e.get("cycle") for e in run["profiling"]
                     if e.get("event") == "worker_start_requested")
    cycles_rows = _injob_cycles(run, 0)
    launches = {k: sum(c["launches"].get(k, 0) for c in cycles_rows)
                for k in ("quorum_local_max", "chunk_fingerprint",
                          "chunk_fingerprint_shards")}
    oom_ev = _event(run, 0, 1, "oom")
    cb = [_event(run, 0, c, "callbacks") for c in (0, 1)]
    status, jobs = fleet["status"], fleet["jobs"]
    job = jobs[0] if len(jobs) == 1 else {}
    comb = fleet["submitted"].get("results", {}).get("combined", {})
    mcp_log = fleet["mcp"]["analyze_log"] or {}
    for i, g in enumerate(gate):
        print(f"attrib phase: (a) cycle {i}: gate {'service' if g['service'] else 'INLINE'} "
              f"{g['category']} resume={g['should_resume']} confidence "
              f"{g['confidence']:.2f} ranks {g['culprit_ranks']} in {g['gate_ms']:.1f} ms "
              f"({card})")
    for c in cycles_rows:
        print(f"attrib phase: (a) cycle {c['cycle']}: spawn to first step "
              f"{c.get('spawn_to_first_step_ms', float('nan')):.1f} ms, restored from "
              f"step {c.get('restored_from')}; kernel launches {c['launches']} ({card})")
    print(f"attrib phase: (a) launcher exit {run['rc']} after {run['wall_s']:.2f} s; "
          f"workers started for cycles {started}; steps per cycle {by_cycle}; the OOM "
          f"worker's allocated bytes at the warning {oom_ev and oom_ev.get('allocated')}; "
          f"timeouts loaded at each start {[e and e['hb_timeouts'] for e in cb]}")
    print(f"attrib phase: (b) smonsvc status {json.dumps(status)}")
    print(f"attrib phase: (b) /jobs {json.dumps(jobs)}; submit: combined "
          f"{comb.get('category')} resume={comb.get('should_resume')}; MCP "
          f"{mcp_log.get('category')} resume={mcp_log.get('should_resume')}; "
          f"{fleet_s:.2f} s")
    print(f"attrib phase: (c) DCP {dcp['leaves']} leaves, {dcp['bytes']} B: save "
          f"{dcp['save_ms']:.1f} ms, load {dcp['load_ms']:.1f} ms, migrate "
          f"{dcp['migrate_ms']:.1f} ms ({dcp['fp_launches']} fingerprint launch(es) "
          f"over {dcp['fp_shards']} leaves), "
          f"restore {dcp['restore_ms']:.1f} ms; bit for bit "
          f"{dcp['dcp_bit_for_bit']}/{dcp['migrated_bit_for_bit']}; {dcp_s:.2f} s; "
          f"phase {wall_s:.2f} s ({card})")

    claims = (
        ("(a) the gate consulted the spawned service for both cycles, never inline",
         len(gate) == 2 and all(g["service"] for g in gate)
         and "attribution service up at" in run["stderr"]),
        ("(a) cycle 0's crash: resume true, restart allowed",
         bool(gate) and gate[0]["should_resume"] and started[:2] == [0, 1]),
        ("(a) cycle 1's CUDA OOM: oom_hbm, resume false, confidence >= 0.8, "
         "culprit ranks [0]",
         len(gate) == 2 and gate[1]["category"] == "oom_hbm"
         and not gate[1]["should_resume"] and gate[1]["confidence"] >= 0.8
         and gate[1]["culprit_ranks"] == [0]),
        ("(a) the launcher stops non-zero and starts no cycle 2",
         run["rc"] not in (0, None) and started == [0, 1]
         and "not survivable by restart" in run["stderr"]),
        ("(a) the real OutOfMemoryError and the memory logger's warning in the "
         "cycle-1 log",
         "torch.OutOfMemoryError" in log1 and "CUDA out of memory" in log1
         and (not on_card or "device memory" in log1 and "% full" in log1)),
        ("(a) the callbacks' timeouts: cycle 1 starts with cycle 0's learned ones",
         cb[1] is not None and cb[1]["hb_timeouts"] is not None
         and cb[1]["hb_timeouts"].get("were_calculated") is True),
        ("(a) every loss up to each fault equals the in-job phase's clean run's "
         "bit for bit",
         not mismatched and by_cycle[0] == list(range(ATTRIB_FAULTS[0][1]))
         and by_cycle[1] and by_cycle[1][-1] == ATTRIB_FAULTS[1][1] - 1),
        ("(a) kernels 1 and 2 launched in the workers", not on_card or (
            launches["quorum_local_max"] > 0 and launches["chunk_fingerprint"] > 0)),
        ("(a) kernel 2 launched once per save over the worker's owned leaves",
         not on_card or _fp_per_save((run,))),
        ("(b) smonsvc: the job's two cycles ended, both failed, both verdicts "
         "from the port's attrsvc, cycle 1 oom_hbm",
         status["totals"] == {"jobs_seen": 1, "cycles_observed": 2,
                              "cycles_failed": 2, "logs_submitted": 2}
         and status["restarts_15m"] == 2 and status["verdicts"].get("oom_hbm") == 1
         and sum(status["verdicts"].values()) == 2
         and job.get("last_cycle") == 1
         and job.get("last_end_reason") == "worker_failure"
         and job.get("verdicts") == status["verdicts"]),
        ("(b) the job's state: RUNNING within smonsvc's idle threshold, FAILED "
         "past it",
         job.get("state") == "RUNNING" and fleet["state_past_idle"] == "FAILED"),
        ("(b) POST /submit of cycle 1's log: combined oom_hbm, resume false",
         comb.get("category") == "oom_hbm" and comb.get("should_resume") is False),
        ("(b) the MCP server over stdio: initialize, tools/list, analyze_log oom_hbm",
         fleet["mcp"]["rc"] == 0 and fleet["mcp"]["ids"] == [1, 2, 3]
         and fleet["mcp"]["tools"] == ["analyze_combined", "analyze_log",
                                        "analyze_trace"]
         and mcp_log.get("category") == "oom_hbm"
         and mcp_log.get("should_resume") is False),
        ("(c) the DCP save loads in place and migrates, bit for bit",
         dcp["dcp_bit_for_bit"] and dcp["migrated_bit_for_bit"]),
        ("(c) the flagship state, one fingerprint launch over every leaf",
         not on_card or (
            dcp["leaves"] == ATTRIB_FLAGSHIP_LEAVES
            and dcp["bytes"] == ATTRIB_FLAGSHIP_BYTES
            and dcp["fp_launches"] == 1
            and dcp["fp_shards"] == ATTRIB_FLAGSHIP_LEAVES)),
        (f"the phase within {ATTRIB_BOUND_S:.0f} s", wall_s <= ATTRIB_BOUND_S),
    )
    for claim, met in claims:
        print(f"attrib phase: {claim}: {'met' if met else 'NOT met'}")
    failed = [c for c, met in claims if not met]
    if failed:
        print(f"attrib phase: launcher stderr tail:\n{run['stderr'][-4000:]}\n"
              f"cycle 1 log tail:\n{log1[-3000:]}")
        raise AssertionError(
            f"attrib phase: {failed} failed: gate {gate}, mismatched "
            f"{mismatched[:5]}, started {started}, fleet {fleet}, dcp {dcp}")
    return {
        "gate": gate, "launcher_rc": run["rc"], "cycles_started": started,
        "launches": launches, "cycles": cycles_rows,
        "oom_allocated": oom_ev and oom_ev.get("allocated"),
        "status": status, "jobs": jobs, "state_past_idle": fleet["state_past_idle"],
        "submit_combined": {k: comb.get(k) for k in (
            "category", "should_resume", "confidence", "culprit_ranks")},
        "mcp_analyze_log": {k: mcp_log.get(k) for k in (
            "category", "should_resume", "confidence", "culprit_ranks")},
        "dcp": dcp, "wall_s": {"a": run["wall_s"], "b": fleet_s, "c": dcp_s},
        "phase_s": wall_s,
    }


# examples phase: the port's examples (``examples/torch/``) on the card
EXAMPLES = os.path.join("examples", "torch")
EXAMPLE_RUN_TIMEOUT_S = {"advanced": 120.0, "restart": 150.0, "async_ckpt": 120.0,
                         "straggler": 120.0, "train": 240.0}
EXAMPLE_RESTART_STEPS = 60      # 0.1 s each: the survivor's iteration outlasts detection
EXAMPLE_TRAIN_STEPS = 160
EXAMPLE_SAVE_EVERY = 20         # train_with_launcher.py's SAVE_EVERY
EXAMPLE_KILL_S = 10.0           # TPURX_FAULT=sigkill:<s> into cycle 0
EXAMPLE_ASYNC_SAVES = 4         # async_ckpt.py: steps 0, 10, 20, then the delta save
EXAMPLES_BOUND_S = 180.0


def example_run(script: str, args: list) -> int:
    """``python3 chip_smoke.py --example-run <script> [args]``: run a port
    example as ``__main__`` in this process, then write its kernel launch
    counts and its saves into ``$CHIP_SMOKE_EXAMPLE_OUT`` (also when it
    raises; a SIGKILLed process writes nothing)."""
    import runpy

    path = os.path.join(HERE, script)
    sys.argv = [path, *args]
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        q = sys.modules.get("tpu_resiliency_torch.ops.quorum")
        dd = sys.modules.get(
            "tpu_resiliency_torch.checkpointing.async_ckpt.device_digest")
        ck = sys.modules.get(
            "tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer")
        counts = {
            "quorum_local_max": q.local_max.launches if q else 0,
            "chunk_fingerprint": dd.batch_fingerprints.launches if dd else 0,
            "chunk_fingerprint_shards": dd.batch_fingerprints.shards if dd else 0,
            "saves": int(ck._SAVES.value) if ck else 0,
            "cycle": int(os.environ.get("TPURX_CYCLE", "0")),
            "rank": int(os.environ.get("TPURX_RANK", "0")),
        }
        out = os.environ.get("CHIP_SMOKE_EXAMPLE_OUT")
        if out:
            name = f"counts.c{counts['cycle']}.r{counts['rank']}.{os.getpid()}.json"
            with open(os.path.join(out, name), "w") as f:
                json.dump(counts, f)
    return 0


def _async_ckpt_state(torch, dev) -> dict:
    """``async_ckpt.py``'s state, drawn here from the same seed."""
    import numpy as np

    g = torch.Generator(dev).manual_seed(0)
    return {"params": {"w": torch.randn((256, 256), generator=g, device=dev),
                       "b": torch.zeros((256,), device=dev)},
            "opt": {"m": torch.zeros((256, 256), device=dev),
                    "v": torch.zeros((256, 256), device=dev)},
            "step": np.int64(0)}


def _same_leaf(torch, a, b) -> bool:
    import numpy as np

    if isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and a.device == b.device
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _example_env(out: str, device, extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPURX_", "FT_", "CHIP_SMOKE"))}
    env.update({"TPURX_REPO": HERE, "CHIP_SMOKE_EXAMPLE_OUT": out})
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"   # processes beside each other on one host
    env.update(extra)
    return env


def _example_cmd(script: str, device, args=()) -> list:
    dev = ["--device", device] if device is not None else []
    return [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--example-run",
            os.path.join(EXAMPLES, script), *dev, *args]


def _kill_session(proc: subprocess.Popen) -> None:
    """SIGKILL what is left of ``proc``'s session (a session leader): the
    helper processes an example started and did not stop."""
    try:
        os.killpg(proc.pid, 9)
    except ProcessLookupError:
        pass


def _example_counts(out: str) -> list:
    return [json.loads(_read(os.path.join(out, f))) for f in sorted(os.listdir(out))
            if f.startswith("counts.")]


def _example(name: str, script: str, out: str, device, env: dict, timeout: float,
             args=()) -> dict:
    """One example as a process of its own: exit code, wall seconds, output,
    and the kernel launches its process counted."""
    os.makedirs(out, exist_ok=True)
    t0 = time.monotonic()
    with open(os.path.join(out, "out"), "w") as fo, \
            open(os.path.join(out, "err"), "w") as fe:
        proc = subprocess.Popen(_example_cmd(script, device, args), cwd=HERE,
                                env=_example_env(out, device, env), stdout=fo, stderr=fe,
                                start_new_session=True)
    rc = _wait_or_kill(proc, t0 + timeout)
    _kill_session(proc)
    counts = _example_counts(out)
    run = {"name": name, "rc": rc, "wall_s": time.monotonic() - t0,
           "stdout": _read(os.path.join(out, "out")),
           "stderr": _read(os.path.join(out, "err")),
           "counts": counts[0] if counts else {}}
    print(f"examples phase: {name}: exit {rc} after {run['wall_s']:.2f} s, "
          f"launches {run['counts']}", flush=True)
    return run


def _sentinel(run: dict, line: str) -> bool:
    found = line in run["stdout"]
    print(f"examples phase: {run['name']}: sentinel {line!r} "
          f"{'found' if found else 'NOT found'}", flush=True)
    return found


def _example_restart(out: str, device) -> dict:
    """``inprocess_restart.py`` as two ranks sharing the card over the
    port's store server: rank 1 is SIGKILLed once both ranks run iteration
    0, and rank 0 must re-enter ``train`` as a world of one and finish."""
    from tpu_resiliency_torch.store import StoreServer

    server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
    procs, outs = [], [os.path.join(out, f"r{r}") for r in range(2)]

    def text(r):
        return _read(os.path.join(outs[r], "out"))

    t0 = time.monotonic()
    deadline = t0 + EXAMPLE_RUN_TIMEOUT_S["restart"]
    run = {"name": "inprocess_restart", "rc": None}
    try:
        for r in range(2):
            os.makedirs(outs[r], exist_ok=True)
            env = _example_env(outs[r], device, {
                "TPURX_RANK": str(r), "TPURX_WORLD_SIZE": "2",
                "TPURX_STORE_ADDR": "127.0.0.1", "TPURX_STORE_PORT": str(server.port)})
            with open(os.path.join(outs[r], "out"), "w") as fo, \
                    open(os.path.join(outs[r], "err"), "w") as fe:
                procs.append(subprocess.Popen(
                    _example_cmd("inprocess_restart.py", device,
                                 ("--steps", str(EXAMPLE_RESTART_STEPS))),
                    cwd=HERE, env=env, stdout=fo, stderr=fe, start_new_session=True))
        while time.monotonic() < deadline and not all(
                f"rank {r}: step 0" in text(r) for r in range(2)):
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.02)
        run["start_s"] = time.monotonic() - t0
        killed = all(f"rank {r}: step 0" in text(r) for r in range(2))
        if killed:
            t_kill = time.monotonic()
            os.kill(procs[1].pid, 9)
            while time.monotonic() < deadline and procs[0].poll() is None \
                    and "iteration=1" not in text(0):
                time.sleep(0.02)
            if "iteration=1" in text(0):
                run["kill_to_reentry_ms"] = (time.monotonic() - t_kill) * 1e3
        run["rc"] = _wait_or_kill(procs[0], deadline)
        run["killed_rc"] = _wait_or_kill(procs[1], deadline)
    finally:
        for p in procs:
            _kill_session(p)
            p.wait()
        server.stop()
    run.update({"wall_s": time.monotonic() - t0, "killed": killed,
                "stdout": text(0), "stderr": _read(os.path.join(outs[0], "err")),
                "counts": (_example_counts(outs[0]) or [{}])[0]})
    print(f"examples phase: inprocess_restart: rank 0 exit {run['rc']}, rank 1 "
          f"exit {run['killed_rc']} (SIGKILLed {killed}), both in iteration 0 "
          f"after {run['start_s']:.2f} s, kill to rank 0's re-entry "
          f"{run.get('kill_to_reentry_ms', float('nan')):.1f} ms, "
          f"{run['wall_s']:.2f} s in all", flush=True)
    return run


def _example_train(out: str, device, steps: int, kill_s: float) -> dict:
    """``train_with_launcher.py`` under the port's launcher, one worker, its
    rank 0 SIGKILLed ``kill_s`` into cycle 0.  A thread samples the
    progress file and the committed checkpoints every 2 ms, so the state
    at the kill is known after cycle 1 has overwritten the progress."""
    from tpu_resiliency_torch.checkpointing.async_ckpt.writer import is_committed

    os.makedirs(out, exist_ok=True)
    ckpt_dir, progress = os.path.join(out, "ckpt"), os.path.join(out, "progress")
    env = _example_env(out, device, {
        "STEPS": str(steps), "CKPT_DIR": ckpt_dir,
        "PROGRESS_FILE": progress,
        "TPURX_FAULT": f"sigkill:{kill_s}", "TPURX_FAULT_RANKS": "0",
        "TPURX_FAULT_CYCLES": "0", "TPURX_CKPT_DEVICE_DIGEST": "1",
        "TPURX_FT_ENABLE_DEVICE_HEALTH_CHECK": "0",
        "TPURX_FT_INITIAL_RANK_HEARTBEAT_TIMEOUT": "180",
        "TPURX_FT_RANK_HEARTBEAT_TIMEOUT": "60",
        "TPURX_FT_WORKLOAD_CHECK_INTERVAL": "0.1",
        "TPURX_FT_WORKERS_STOP_TIMEOUT": "10",
        "TPURX_PROFILING_FILE": os.path.join(out, "profiling.jsonl"),
    })
    cmd = [sys.executable, "-m", "tpu_resiliency_torch.fault_tolerance.launcher",
           "--nnodes", "1", "--nproc-per-node", "1", "--host-store",
           "--rdzv-endpoint", f"127.0.0.1:{_free_port_run()}",
           "--max-restarts", "3", "--monitor-interval", "0.05",
           *_example_cmd("train_with_launcher.py", device)[1:]]
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            try:
                with open(progress) as f:
                    value = int(f.read() or -1)
            except (OSError, ValueError):
                value = None
            names = os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else ()
            committed = sorted(int(n.split("_")[1]) for n in names
                               if n.startswith("step_")
                               and is_committed(os.path.join(ckpt_dir, n)))
            samples.append((time.monotonic_ns(), value, committed))
            stop.wait(0.002)

    t0 = time.monotonic()
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    with open(os.path.join(out, "out"), "w") as fo, \
            open(os.path.join(out, "err"), "w") as fe:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=fo, stderr=fe,
                                start_new_session=True)
    rc = _wait_or_kill(proc, t0 + EXAMPLE_RUN_TIMEOUT_S["train"])
    _kill_session(proc)
    stop.set()
    sampler.join()
    prof = sorted((e for e in _jsonl(os.path.join(out, "profiling.jsonl"))
                   if "mono_ns" in e), key=lambda e: e["mono_ns"])
    starts = {e.get("cycle"): e["mono_ns"] for e in prof
              if e.get("event") == "worker_start_requested"}
    stdout = _read(os.path.join(out, "out"))
    resumed = [int(v) for v in re.findall(r"\[rank 0\] resumed from step (\d+)", stdout)]
    at_kill = [s for s in samples if 1 in starts and s[0] < starts[1]]
    p_kill, committed = (at_kill[-1][1], at_kill[-1][2]) if at_kill else (None, [])
    counts = {c["cycle"]: c for c in _example_counts(out)}
    run = {"name": "train_with_launcher", "rc": rc, "wall_s": time.monotonic() - t0,
           "stdout": stdout, "stderr": _read(os.path.join(out, "err")),
           "cycles": sorted(starts), "resumed_from": resumed,
           "progress_at_kill": p_kill, "committed_at_kill": committed,
           "steps_lost": (p_kill - resumed[0]) if resumed and p_kill is not None else None,
           "final_progress": samples[-1][1] if samples else None,
           "counts": counts.get(1, {}), "counts_by_cycle": counts}
    if 1 in starts and 0 in starts:
        run["cycle_0_s"] = (starts[1] - starts[0]) / 1e9
    # the saves the resumed cycle issued: every SAVE_EVERY-th step after the resume
    first = resumed[0] + 1 if resumed else 0
    run["steps"] = steps
    run["saves_expected_cycle_1"] = len([s for s in range(first, steps)
                                         if s % EXAMPLE_SAVE_EVERY == 0])
    print(f"examples phase: train_with_launcher: launcher exit {rc} after "
          f"{run['wall_s']:.2f} s, cycles {run['cycles']}, cycle 0 "
          f"{run.get('cycle_0_s', float('nan')):.2f} s to the respawn; progress "
          f"at the kill {p_kill}, committed then {committed}, resumed from "
          f"{resumed}, steps lost {run['steps_lost']}, final progress "
          f"{run['final_progress']}; cycle 1 launches {run['counts']}", flush=True)
    return run


def examples_phase(torch, card: str, device=None) -> dict:
    """The port's examples (phase 19): items that do device work, each a
    process of its own with its default device (``device="cpu"`` passes
    ``--device cpu`` and waives the launch claims, which count card
    launches)."""
    on_card = device is None
    root = tempfile.mkdtemp(prefix="tpurx_examples_")
    t_phase = time.monotonic()
    try:
        from tpu_resiliency_torch.checkpointing.async_ckpt.checkpointer import (
            load_checkpoint,
        )
        from tpu_resiliency_torch.store import StoreServer
        from tpu_resiliency_torch.utils.tree import leaves

        # the three one-process examples side by side (none claims a time),
        # each a process of its own; the two that kill a process after them
        server = StoreServer(host="127.0.0.1", port=0).start_in_thread()
        ckpt_dir = os.path.join(root, "async_ckpt", "ckpt")
        try:
            advanced_result = _beside(
                _example, "advanced_example", "inprocess/advanced_example.py",
                os.path.join(root, "advanced"), device, {
                    "TPURX_RANK": "0", "TPURX_WORLD_SIZE": "1",
                    "TPURX_STORE_ADDR": "127.0.0.1",
                    "TPURX_STORE_PORT": str(server.port)},
                EXAMPLE_RUN_TIMEOUT_S["advanced"])
            async_ckpt_result = _beside(
                _example, "async_ckpt", "checkpointing/async_ckpt.py",
                os.path.join(root, "async_ckpt"), device,
                {"TPURX_CKPT_DEVICE_DIGEST": "1"}, EXAMPLE_RUN_TIMEOUT_S["async_ckpt"],
                ("--ckpt-dir", ckpt_dir))
            straggler = _example("straggler", "straggler/example.py",
                                 os.path.join(root, "straggler"), device, {},
                                 EXAMPLE_RUN_TIMEOUT_S["straggler"])
            advanced, async_ckpt = advanced_result(), async_ckpt_result()
        finally:
            server.stop()
        restart = _example_restart(os.path.join(root, "restart"), device)
        # the restores again here, against the state drawn from the same seed
        dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
        want = _async_ckpt_state(torch, dev)
        state_bytes = sum(t.numel() * t.element_size() for t in leaves(want)
                          if isinstance(t, torch.Tensor))
        restored_bits = {}
        for name in ("step_20", "step_30"):
            got = load_checkpoint(os.path.join(ckpt_dir, name), template=want)
            restored_bits[name] = all(_same_leaf(torch, a, b) for a, b in
                                      zip(leaves(got), leaves(want)))
        # the CPU rehearsal's steps take ~20 ms at the small config
        train = _example_train(os.path.join(root, "train"), device,
                               *((EXAMPLE_TRAIN_STEPS, EXAMPLE_KILL_S) if on_card
                                 else (500, 5.0)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall_s = time.monotonic() - t_phase
    written = re.search(r"delta save of the unchanged state: (\S+) bytes written, "
                        r"(\S+) bytes of device-to-host copy skipped",
                        async_ckpt["stdout"])
    lost = train["steps_lost"]
    claims = (
        ("advanced_example.py exits 0 with 'result: done'",
         advanced["rc"] == 0 and _sentinel(advanced, "result: done")),
        ("inprocess_restart.py: rank 1 SIGKILLed, rank 0 re-enters as a world "
         "of one and finishes", restart["killed"] and restart["rc"] == 0
         and restart["killed_rc"] == -9
         and _sentinel(restart, "train: rank=0/1 iteration=1")
         and restart["stdout"].rstrip().endswith("finished")),
        ("async_ckpt.py exits 0 with 'async checkpoint roundtrip OK'",
         async_ckpt["rc"] == 0 and _sentinel(async_ckpt, "async checkpoint roundtrip OK")),
        ("async_ckpt.py: the delta save of the unchanged state writes 0 bytes",
         written is not None and written.group(1) == "0"),
        ("async_ckpt.py: the delta save copies none of the state's "
         f"{state_bytes} B from the card (the fingerprint matched every leaf)",
         written is not None and int(written.group(2)) == state_bytes),
        ("async_ckpt.py: step_20 and the delta step_30 restore bit for bit",
         all(restored_bits.values())),
        ("straggler/example.py exits 0 with 'always-on collector: 16 samples'",
         straggler["rc"] == 0
         and _sentinel(straggler, "always-on collector: 16 samples")),
        ("train_with_launcher.py: the launcher exits 0 after cycles 0 and 1, "
         "and rank 0 finishes every step", train["rc"] == 0
         and train["cycles"] == [0, 1]
         and _sentinel(train, "[rank 0] done: loss=")
         and train["final_progress"] == train["steps"] - 1),
        ("train_with_launcher.py resumes from the latest step committed at "
         "the kill", bool(train["committed_at_kill"])
         and train["resumed_from"] == [max(train["committed_at_kill"])]),
        (f"train_with_launcher.py loses at most its save interval "
         f"({EXAMPLE_SAVE_EVERY} steps)",
         lost is not None and 0 <= lost <= EXAMPLE_SAVE_EVERY),
        ("kernel 1 launched in advanced_example.py's tick lane", not on_card
         or advanced["counts"].get("quorum_local_max", 0) >= 1),
        ("kernel 2 launched once per save in async_ckpt.py", not on_card or (
            async_ckpt["counts"].get("saves") == EXAMPLE_ASYNC_SAVES
            and async_ckpt["counts"].get("chunk_fingerprint") == EXAMPLE_ASYNC_SAVES)),
        ("kernel 2 launched once per save in train_with_launcher.py's cycle 1",
         not on_card or (
             train["counts"].get("saves") == train["saves_expected_cycle_1"] >= 1
             and train["counts"].get("chunk_fingerprint") == train["counts"]["saves"])),
        (f"the phase within {EXAMPLES_BOUND_S:.0f} s", wall_s <= EXAMPLES_BOUND_S),
    )
    for claim, met in claims:
        print(f"examples phase: {claim}: {'met' if met else 'NOT met'}")
    runs = (advanced, restart, async_ckpt, straggler, train)
    failed = [c for c, met in claims if not met]
    if failed:
        for run in runs:
            print(f"examples phase: {run['name']}: stderr tail:\n"
                  f"{run['stderr'][-3000:]}\nstdout tail:\n{run['stdout'][-3000:]}")
        raise AssertionError(f"examples phase: {failed} failed")
    print(f"examples phase: {wall_s:.2f} s ({card})")
    return {
        "wall_s": {run["name"]: run["wall_s"] for run in runs},
        "phase_s": wall_s,
        "launches": {run["name"]: run["counts"] for run in runs},
        "restart": {k: restart.get(k) for k in ("start_s", "kill_to_reentry_ms")},
        "async_ckpt": {"delta_bytes_written": int(written.group(1)),
                       "delta_d2h_skipped_bytes": int(written.group(2)),
                       "restored_bit_for_bit": restored_bits},
        "train": {k: train.get(k) for k in (
            "cycles", "cycle_0_s", "progress_at_kill", "committed_at_kill",
            "resumed_from", "steps_lost", "final_progress", "counts_by_cycle")},
    }


# soak phase: the port's chaos soak, each campaign a run of
# ``python -m tpu_resiliency_torch.soak`` on the card.  (a) is the gate's
# mix compressed to 120 s with the JAX smoke's probabilities and bounds;
# (b)-(d) run beside it, and the four beside the examples phase.  (e) runs
# after the examples, 40 s an arm: the smoke's 20 s arm is about one worker
# start on the card (8-17 s), and such arms ended with no step or inside
# the first restart
SOAK_CAMPAIGNS = {
    "a": ["--seconds", "120", "--chaos-store", "--quorum", "--store-kill-mid-save",
          "--exc-p", "0.02", "--qstall-p", "0.012", "--cwedge-p", "0.008",
          "--store-kill-every", "18", "28",
          "--inner-bound-ms", "15000", "--outer-bound-ms", "60000"],
    "b": ["--seconds", "60", "--corrupt-blob", "bitflip"],
    "c": ["--seconds", "110", "--link-degrade"],
    "d": ["--seconds", "40", "--store-longpoll-abort", "--longpoll-bound-s", "10.0"],
    "e": ["--fault-shift", "--seconds", "40", "--fault-seed", "11"],
}
SOAK_RUN_TIMEOUT_S = 270.0
SOAK_BOUND_S = 300.0


def _soak_start(name: str, out: str, device) -> tuple:
    """One campaign as ``python -m tpu_resiliency_torch.soak`` in a session
    of its own, its output to files under ``out`` and its temporary files
    (its workdir, so its counts directory) under ``out`` too."""
    dev = ["--device", device] if device is not None else []
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPURX_", "FT_", "CHIP_SMOKE"))}
    env["TMPDIR"] = out
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with open(os.path.join(out, f"{name}.out"), "w") as fo, \
            open(os.path.join(out, f"{name}.err"), "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_resiliency_torch.soak", *SOAK_CAMPAIGNS[name], *dev],
            cwd=HERE, env=env, stdout=fo, stderr=fe, start_new_session=True)
    return proc, time.monotonic()


def _soak_finish(name: str, out: str, started: tuple) -> dict:
    """Wait for a campaign (killing its session at the bound) and read the
    report it printed last."""
    from tpu_resiliency_torch.soak.launcher import _stop_child

    proc, t0 = started
    try:
        rc = proc.wait(timeout=max(0.0, t0 + SOAK_RUN_TIMEOUT_S - time.monotonic()))
    except subprocess.TimeoutExpired:
        rc = None
    _stop_child(proc)
    stdout = _read(os.path.join(out, f"{name}.out"))
    last = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    run = {"name": name, "rc": rc, "wall_s": time.monotonic() - t0,
           "report": json.loads(last[-1]) if last else {}, "stdout": stdout,
           "stderr": _read(os.path.join(out, f"{name}.err"))}
    print(f"soak phase: ({name}) {' '.join(SOAK_CAMPAIGNS[name])}: exit {rc} after "
          f"{run['wall_s']:.2f} s; report {json.dumps(run['report'])}", flush=True)
    return run


def _soak_processes(out: str) -> dict:
    """Live processes this phase's campaigns started, pid -> command line:
    those whose environment names ``out`` as their temporary directory or
    holds a counts directory under it (each soak, its launcher, store host,
    rank monitors and workers)."""
    marks = (f"TMPDIR={out}".encode(), f"SOAK_COUNTS_DIR={out}{os.sep}".encode())
    found = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                environ = f.read().split(b"\0")
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().replace(b"\0", b" ")
        except OSError:
            continue
        if any(kv == marks[0] or kv.startswith(marks[1]) for kv in environ):
            found[int(pid)] = argv.decode(errors="replace")[:200]
    return found


def _card_pids() -> set:
    """Pids of the compute processes on the card (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return set()
    return {int(x) for x in out.split() if x.strip().isdigit()}


def soak_start(device=None) -> dict:
    """Start the soak phase's campaigns (a)-(d), to run beside the examples
    phase; :func:`soak_phase` then runs (e) and holds the claims."""
    out = tempfile.mkdtemp(prefix="tpurx_soak_phase_")
    t0 = time.monotonic()
    return {"device": device, "out": out, "t0": t0,
            "started": {name: _soak_start(name, out, device) for name in "abcd"}}


def soak_stop(st: dict) -> None:
    """Stop every campaign :func:`soak_start` or :func:`soak_phase` started
    (each soak cleans up its own process tree on SIGTERM)."""
    from tpu_resiliency_torch.soak.launcher import _stop_child

    for proc, _t0 in st["started"].values():
        _stop_child(proc)


def soak_phase(card: str, st: dict) -> dict:
    """The port's chaos soak (phase 20): five campaigns of ``python -m
    tpu_resiliency_torch.soak``, their workers on the card
    (``device="cpu"`` passes ``--device cpu`` and waives the claims that
    count card launches).  ``st`` is :func:`soak_start`'s handle: (a)-(d)
    ran beside the examples phase; (e), the goodput A/B, starts here once
    (b)-(d) have ended, beside the rest of (a)."""
    device, out, t_phase, started = st["device"], st["out"], st["t0"], st["started"]
    on_card = device is None
    runs = {}
    try:
        for name in "cdb":      # they end before (a)
            runs[name] = _soak_finish(name, out, started[name])
        e_at_s = time.monotonic() - t_phase
        started["e"] = _soak_start("e", out, device)
        for name in "ae":
            runs[name] = _soak_finish(name, out, started[name])
    finally:
        soak_stop(st)
    wall_s = time.monotonic() - t_phase
    left = _soak_processes(out)
    on_card_left = sorted(_card_pids() & set(left)) if on_card else []
    shutil.rmtree(out, ignore_errors=True)
    a, b, c, d, e = (runs[k]["report"] for k in "abcde")
    inj = a.get("injected", {})
    arms = e.get("arms", {})
    arm_steps = [(arms.get(arm) or {}).get("final_progress") or 0
                 for arm in ("fixed", "adaptive")]
    arm_devices = [dv for arm in arms.values() for dv in arm.get("worker_devices") or ["?"]]
    claims = (
        ("(a) the gate's mix: ok, monotone progress, the ladder's fingerprint rung",
         runs["a"]["rc"] == 0 and bool(a.get("ok")) and bool(a.get("monotone_progress"))
         and bool(a.get("ladder_ok"))),
        ("(a) at least one store kill, one inner recovery and one fingerprint/released",
         a.get("store_kills", 0) >= 1 and a.get("inner_ring_recoveries", 0) >= 1
         and a.get("abort_stage_outcomes", {}).get("fingerprint/released", 0) >= 1),
        ("(a) a restart cycle for the crashes and hangs injected",
         bool(a) and (inj.get("crashes", 0) + inj.get("hangs", 0) == 0
                      or a.get("cycles", 0) >= 1)),
        ("(a) every started save completed through the store kills",
         bool(a.get("saves_ok")) and a.get("saves_started", 0) >= 1),
        ("(a) kernel 1 launched in the workers' tick lanes", not on_card
         or a.get("kernel1_launches", 0) > 0),
        ("(a) every worker ran on the card", bool(a.get("workers")) and all(
            dv.startswith("cuda" if on_card else "cpu") for dv in a.get("worker_devices", ["?"]))),
        ("(b) corrupt blobs detected, quarantined, every rank restored an older "
         "iteration bit for bit", runs["b"]["rc"] == 0 and bool(b.get("ok"))
         and bool(b.get("ckpt_ok")) and b.get("cycles", 0) >= 1
         and {r[0] for r in b.get("fallback_restores", [])} == {0, 1}),
        ("(c) the bad link degraded on the armed rank only, with zero restarts",
         runs["c"]["rc"] == 0 and bool(c.get("coll_ok")) and c.get("cycles") == 0
         and c.get("coll_degrades", 0) >= 1 and c.get("coll_timeouts", 0) >= 1),
        ("(d) every long-poll abort landed within the bound, no ret=None",
         runs["d"]["rc"] == 0 and bool(d.get("lp_ok"))
         and d.get("lp_episodes_landed", 0) >= 1 and d.get("lp_ret_none") == 0),
        ("(e) the goodput A/B: both arms ok, a finite gain, at least one step "
         "saved in each arm (its own progress, not the gain's floor of 1)",
         bool(e.get("arms_ok")) and math.isfinite(e.get("policy_goodput_gain", math.nan))
         and e.get("policy_goodput_gain", 0) > 0 and min(arm_steps) > 0),
        ("(e) both arms' workers ran on the card", len(arms) == 2 and all(
            dv.startswith("cuda" if on_card else "cpu") for dv in arm_devices)),
        ("no process of the phase's campaigns is left, on the card or off it",
         not left and not on_card_left),
        (f"the phase within {SOAK_BOUND_S:.0f} s", wall_s <= SOAK_BOUND_S),
    )
    for claim, met in claims:
        print(f"soak phase: {claim}: {'met' if met else 'NOT met'}")
    print(f"soak phase: (e) progress fixed / adaptive {arm_steps[0]} / {arm_steps[1]}, "
          f"policy_goodput_gain {e.get('policy_goodput_gain')} (the 1.1x gate "
          f"{'met' if e.get('ok') else 'NOT met'}); (a) kernel 1 launches "
          f"{a.get('kernel1_launches')}, inner / outer median "
          f"{a.get('inner_detect_to_recover_ms_median')} / "
          f"{a.get('outer_detect_to_recover_ms_median')} ms; (e) started at "
          f"{e_at_s:.2f} s; {wall_s:.2f} s ({card})",
          flush=True)
    failed = [cl for cl, met in claims if not met]
    if failed:
        for run in runs.values():
            print(f"soak phase: ({run['name']}) stderr tail:\n{run['stderr'][-3000:]}\n"
                  f"stdout tail:\n{run['stdout'][-3000:]}")
        raise AssertionError(f"soak phase: {failed} failed; left {left}, on the "
                             f"card {on_card_left}")
    return {"reports": {k: runs[k]["report"] for k in "abcde"},
            "wall_s": {k: runs[k]["wall_s"] for k in "abcde"}, "phase_s": wall_s,
            "e_started_at_s": e_at_s,
            "kernel1_launches": a["kernel1_launches"]}


def check_phase(torch, tr, adamw) -> int:
    """The model on the card (f32, no TF32) against the CPU at a small size;
    returns kernel 4's launches in the card's step."""
    cfg = tr.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128, max_seq=32, dtype=torch.float32)
    losses, launches = {}, {}
    for device in ("cpu", None):
        params = tr.init_params(cfg, torch.Generator("cpu").manual_seed(1),
                                device=device)
        opt = tr.init_opt_state(params)
        batch = tr.make_batch(cfg, 2, 32, seed=1, device=device)
        step = tr.make_train_step(cfg, lr=1e-2)
        before = adamw.fused_adamw.launches
        _, _, first = step(params, opt, batch)
        launches[device] = adamw.fused_adamw.launches - before
        second = tr.loss_fn(params, batch, cfg).detach()
        losses[device] = (float(first), float(second))
    if launches != {"cpu": 0, None: 1}:
        raise AssertionError(f"fused AdamW launches in the check's CPU and card "
                             f"steps: {launches['cpu']}, {launches[None]}, not 0, 1")
    cpu, card = losses["cpu"], losses[None]
    # f32 sums in another order on the card: 1e-4 relative is ~1000 ulp
    for a, b in zip(cpu, card):
        if not math.isfinite(b) or abs(a - b) > 1e-4 * abs(a):
            raise AssertionError(f"card loss {card} disagrees with CPU {cpu}")
    print(f"check phase: small model, loss before/after one step: card "
          f"{card[0]:.6f}/{card[1]:.6f}, CPU {cpu[0]:.6f}/{cpu[1]:.6f}; fused "
          f"AdamW launches {launches[None]} on the card, 0 on the CPU")
    return launches[None]


def main() -> int:
    import torch

    if sys.argv[1:] == ["--wedge-child"]:
        return wedge_child()
    if sys.argv[1:2] == ["--mesh-child"] and len(sys.argv) == 5:
        return mesh_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--straggler-child"] and len(sys.argv) == 5:
        return straggler_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    if sys.argv[1:2] == ["--local-child"] and len(sys.argv) == 5:
        return local_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--evac-child"] and len(sys.argv) == 5:
        return evac_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--sanitize-child"] and len(sys.argv) == 4:
        return sanitize_child(int(sys.argv[2]), int(sys.argv[3]))
    if sys.argv[1:2] == ["--example-run"] and len(sys.argv) >= 3:
        return example_run(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from tpu_resiliency_torch.checkpointing.async_ckpt import checkpointer as ckpt_mod
    from tpu_resiliency_torch.checkpointing.async_ckpt import device_digest as dd
    from tpu_resiliency_torch.models import transformer as tr
    from tpu_resiliency_torch.ops import adamw as adamw_mod
    from tpu_resiliency_torch.ops import quorum as q
    from tpu_resiliency_torch.parallel import init_distributed, make_mesh
    from tpu_resiliency_torch.utils import cuda_build
    from tpu_resiliency_torch.utils import tree as tree_mod

    t_script = time.monotonic()

    def timeline(phases: str) -> None:
        print(f"timeline: {phases} ended at {time.monotonic() - t_script:.1f} s",
              flush=True)

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    info = cuda_build.build_all()
    print(f"setup: built {sorted(info)} in {time.monotonic() - t0:.2f}s")
    for src, rec in info.items():
        print(f"setup: {src}: nvcc {rec['seconds']:.2f}s\n{rec['log']}")

    kernel = kernel_phase(torch, np, q)
    digest = digest_phase(torch, np, dd, tr,
                          torch.device("cuda", torch.cuda.current_device()))
    adamw_rec = adamw_phase(torch, tr, adamw_mod,
                            torch.device("cuda", torch.cuda.current_device()))
    check_launches = check_phase(torch, tr, adamw_mod)
    timeline("setup, kernel, digest, adamw, check")

    # -- train phase: the main path -----------------------------------------
    device = init_distributed()
    mesh = make_mesh(("all",))
    cfg = tr.TransformerConfig()
    params = tr.init_params(cfg, torch.Generator(device).manual_seed(0))
    opt = tr.init_opt_state(params)
    batch = tr.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    opt_bytes = sum(t.numel() * t.element_size()
                    for key in ("mu", "nu", "master") for t in opt[key])
    print(f"train phase: {cfg}, {n_params} params, optimizer state "
          f"{opt_bytes / 1e9:.3f} GB, batch {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"{params.embed.dtype} with fp32 master")

    fused_trips, mon_trips = [], []
    fq = q.FusedStepQuorum(
        mesh, budget_ms=1000.0, identify=True,
        on_stale=lambda age, dev: fused_trips.append((time.monotonic(), age, dev)),
    )
    mon = q.QuorumMonitor(
        mesh, budget_ms=1000.0, interval=0.01, identify=True,
        auto_beat_interval=0.005,
        on_stale=lambda age, dev: mon_trips.append((time.monotonic(), age, dev)),
    )
    step = fq.fuse(tr.make_train_step(cfg, lr=1e-3))
    torch.cuda.reset_peak_memory_stats()

    q.local_max.launches = 0
    q.local_max.launches_by_value = 0
    q.local_max.launches_pointer = 0
    adamw_mod.fused_adamw.launches = 0
    adamw_mod.fused_adamw.leaves = 0
    mon.start()
    losses = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            t_start = time.monotonic()
        fq.beat()
        params, opt, loss = step(params, opt, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t_start
    fq.check_now()
    n_steps = WARMUP_STEPS + TIMED_STEPS
    # the tick thread counts a tick just before its launch: read when no
    # tick is between the two (a tick takes microseconds, the interval 10 ms)
    for _ in range(1000):
        ticks = mon.tick_count
        counts = (q.local_max.launches, q.local_max.launches_by_value,
                  q.local_max.launches_pointer)
        if ticks == mon.tick_count and counts[0] == n_steps + ticks:
            break
        time.sleep(0.0005)
    train_launches, by_value, pointer = counts
    adamw_launches = adamw_mod.fused_adamw.launches
    adamw_leaves = adamw_mod.fused_adamw.leaves

    losses = [float(v) for v in losses]
    step_ms = elapsed / TIMED_STEPS * 1e3
    print(f"train phase: losses {[round(v, 4) for v in losses]}")
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(f"train phase: {flops / 1e12:.3f} TFLOP of matmul per step by the "
          f"shapes, {flops / BF16_FLOPS_PER_S * 1e3:.3f} ms at the bf16 dense peak")
    print(f"train phase: {step_ms:.2f} ms/step, "
          f"{TRAIN_BATCH * TRAIN_SEQ * TIMED_STEPS / elapsed:.0f} tokens/s over "
          f"{TIMED_STEPS} steps after {WARMUP_STEPS} warm-up; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"train phase: local max launches {train_launches} "
          f"({n_steps} fused steps + {ticks} monitor ticks), {by_value} by "
          f"value, {pointer} by pointer; fused max age "
          f"{fq.last_max_age_ms} ms, monitor max age {mon.last_max_age} ms")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    if fused_trips or mon_trips:
        raise AssertionError(f"healthy trips: fused {fused_trips}, monitor {mon_trips}")
    n_leaves = len(list(params.parameters()))
    print(f"train phase: fused AdamW launches {adamw_launches} over "
          f"{adamw_leaves} leaves ({n_steps} steps of {n_leaves} leaves)")
    if (adamw_launches, adamw_leaves) != (n_steps, n_steps * n_leaves):
        raise AssertionError(f"fused AdamW launched {adamw_launches} times over "
                             f"{adamw_leaves} leaves for {n_steps} steps of "
                             f"{n_leaves} leaves")
    if ticks < 1 or train_launches != n_steps + ticks or by_value != train_launches:
        raise AssertionError(
            f"local max kernel launched {train_launches} times ({by_value} by "
            f"value, {pointer} by pointer) for {n_steps} fused steps and "
            f"{ticks} ticks"
        )

    # -- ckpt phase: the checkpoint path on the same train state ------------
    ckpt = ckpt_phase(torch, tr, dd, ckpt_mod, tree_mod, params, opt, step, fq,
                      batch, step_ms)
    if fused_trips or mon_trips:
        raise AssertionError(f"trips during the ckpt phase: fused {fused_trips}, "
                             f"monitor {mon_trips}")

    # -- hang phase: freeze both heartbeats ----------------------------------
    mon.budget_ms = HANG_BUDGET_MS
    fq.budget_ms = HANG_BUDGET_MS
    t_freeze = time.monotonic()
    mon.stop_auto_beat()            # and fq.beat() is no longer called
    while not mon_trips and time.monotonic() - t_freeze < 10.0:
        time.sleep(0.001)
    time.sleep(max(0.0, t_freeze + 4 * HANG_BUDGET_MS / 1e3 - time.monotonic()))
    params, opt, loss = step(params, opt, batch)
    fq.check_now()
    mon.stop()
    if not mon_trips or not fused_trips:
        raise AssertionError(f"hang not detected: monitor {mon_trips}, fused {fused_trips}")
    for name, trips in (("monitor", mon_trips), ("fused", fused_trips)):
        t_trip, age, dev = trips[0]
        if t_trip < t_freeze or dev != 0 or age <= HANG_BUDGET_MS:
            raise AssertionError(f"{name} trip wrong: {trips[0]} (freeze at {t_freeze})")
        print(f"hang phase: {name} lane tripped {(t_trip - t_freeze) * 1e3:.2f} ms "
              f"after the freeze, age {age:.3f} ms, device {dev}")

    # -- straggler phase (a): the step through the Detector, native lanes ----
    straggler_a, native_mon, native_trips, bare_step_ms = straggler_world_one(
        torch, q, tr, cfg, mesh, params, opt, batch, card)
    # -- hang phase, native half: freeze the native beater --------------------
    native_hang = native_hang_phase(q, native_mon, native_trips)
    native_hang["bare_step_ms_lanes_stopped"] = bare_step_ms()
    print(f"hang phase (native): the bare fused step with the tick lane, the "
          f"native beater and the tripwire stopped: "
          f"{native_hang['bare_step_ms_lanes_stopped']:.3f} ms (against "
          f"{straggler_a['steps_in_turns_ms']['off']:.3f} ms with them running, "
          f"not in turns) ({card})")

    # -- local phase (a): node-local checkpoints of the train state -----------
    local_a, params, opt = local_world_one(torch, tr, cfg, params, opt, batch, card)

    import torch.distributed as dist

    from tpu_resiliency_torch.parallel import distributed as dist_mod

    dist.destroy_process_group()
    dist_mod.reset()
    del params, opt, step, fq, mon, native_mon
    timeline("train, ckpt, hang, straggler (a), local (a)")

    # -- wrap phase: the in-process restart ring -----------------------------
    wrap = wrap_phase(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    timeline("wrap")

    # -- injob phase: the launcher's restart ring around the trainer ---------
    injob = injob_phase(torch, card)
    timeline("injob")

    # -- control phase: the job-level control plane around the trainer ------
    control = control_phase(torch, card, injob, wrap, cfg, TRAIN_BATCH, TRAIN_SEQ)
    timeline("control")

    # -- policy phase: the adaptive policy loop around the trainer -----------
    policy = policy_phase(torch, card, wrap, cfg, TRAIN_BATCH, TRAIN_SEQ)
    timeline("policy")

    # -- attrib phase: the attribution gate, the fleet services, DCP interop -
    attrib = attrib_phase(torch, card, injob, cfg, TRAIN_BATCH, TRAIN_SEQ)
    timeline("attrib")

    # -- mesh phase (a): the dp x tp sharded step and its sharded save -------
    mesh_a = mesh_world_one(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)

    # -- mesh phase (b) beside local phase (b), (c), none of which claims a --
    # -- time: the (2, 2) mesh; the port's dryrun; node loss across 4 ranks --
    mesh_b_result = _beside(mesh_gloo_four, torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                            mesh_a["losses"][:MESH_STEPS])
    local_b = local_dryrun(card)
    local_c = local_four(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, card)
    mesh = {"a": mesh_a, "b": mesh_b_result()}
    timeline("mesh, local (b), (c)")

    # -- straggler phase (b): four ranks on the card gather over the store ---
    straggler_b = straggler_four(torch, cfg, TRAIN_BATCH, TRAIN_SEQ)
    timeline("straggler (b)")

    # -- wedge phase: the spin kernel in a child the monitor must kill --------
    wedge = wedge_phase(torch, np, q, dd)
    timeline("wedge")

    # -- soak phase (a)-(d): the port's chaos soak, its workers on the card, --
    # -- started here to run beside the examples phase -----------------------
    soak_started = soak_start()

    # -- examples phase: the port's examples, each a process on the card -----
    try:
        examples = examples_phase(torch, card)
    except BaseException:
        soak_stop(soak_started)
        raise
    timeline("examples")

    # -- soak phase: (e), the goodput A/B, then every campaign's claims ------
    soak = soak_phase(card, soak_started)
    timeline("soak")

    t1 = kernel["timings"][1]

    def at(n):
        return {k: kernel["timings"][n][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share")}

    entry = {
        "name": "quorum_local_max",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/quorum_max.cu",
        "replaces": "tpu_resiliency/ops/quorum.py:203",
        "launches": train_launches,
        "launches_by_value": by_value,
        "launches_pointer": pointer,
        "max_abs_err": kernel["max_abs_err"],
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": t1["library_ms"],
        "by_value_ms": t1["by_value_ms"],
        "launch_floor_ms": t1["launch_floor_ms"],
        "kernel_us": t1["ms"] * 1e3,
        "library_us": t1["library_ms"] * 1e3,
        "bound_us": t1["bound_ms"] * 1e3,
        "shape": [1],
        "at_n_1048576": at(1 << 20),
        "at_n_16777216": at(1 << 24),
        "lane_n_local_1": kernel["lane"],
    }
    emb, gib = digest["timings"]["embed"], digest["timings"]["1GiB"]
    whole = digest["timings"]["save"]
    saves = ckpt["saves"]
    fp_entry = {
        "name": "chunk_fingerprint",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/chunk_fingerprint.cu",
        "replaces": "tpu_resiliency/checkpointing/async_ckpt/device_digest.py:129",
        # the main path gives the kernel a save's leaf list: timed over the
        # flagship's whole train state, one batched launch
        "launches": ckpt["launches"],
        "shards": ckpt["shards"],
        "max_abs_err": digest["max_abs_err"],
        "ms": whole["batched_ms"],
        "host_ms": whole["batched_ms_host"],
        "plain_ms": whole["plain_ms"],
        "bound_ms": whole["bound_ms"],
        "bound_by": whole["bound_by"],
        "library_ms": None,
        "leaves": whole["leaves"],
        "nbytes": whole["nbytes"],
        "per_leaf_calls": {"ms": whole["per_leaf_ms"],
                           "host_ms": whole["per_leaf_ms_host"]},
        "cases_checked": digest["checked"],
        "cases_batched": digest["batched"],
        "at_embed": {k: emb[k] for k in ("ms", "ms_host", "plain_ms", "bound_ms",
                                         "bound_by", "bound_share", "nbytes")},
        "at_1GiB": {k: gib[k] for k in ("ms", "ms_host", "plain_ms", "bound_ms",
                                        "bound_by", "bound_share", "nbytes")},
        "ckpt": {
            "leaves": ckpt["n_leaves"],
            "state_bytes": ckpt["total_bytes"],
            "restore_ms": ckpt["restore_ms"],
            "pinned_copy": ckpt["pinned_copy"],
            "saves": {g: {k: saves[g][k] for k in (
                "call_ms", "snapshot_span_ms", "device_digest_s",
                "device_digest_launch_s", "d2h_bytes",
                "d2h_shards", "d2h_skipped_bytes", "d2h_enqueue_s", "stage_s",
                "segment_s",
                "drain_ms", "bytes_written", "launches", "shards")} for g in saves},
            "steps_during_drain_ms": {
                g: saves[g]["steps_during_drain_ms"] for g in DRAIN_STEP_SAVES},
        },
    }
    fp_entry["wrap_launches"] = wrap["launches"]["chunk_fingerprint"]
    entry["wrap_launches"] = wrap["launches"]["quorum_local_max"]
    # the in-job ring's workers, every cycle of every launcher run
    fp_entry["injob_launches"] = injob["launches"]["chunk_fingerprint"]
    entry["injob_launches"] = injob["launches"]["quorum_local_max"]
    # the control phase's workers: (a)'s cycles, (b)'s wrapped run, (c)'s runs
    fp_entry["control_launches"] = control["launches"]["chunk_fingerprint"]
    entry["control_launches"] = control["launches"]["quorum_local_max"]
    # the policy phase: (a)'s wrapped runs, and (b)'s checkpoint-ahead save
    fp_entry["policy_launches"] = policy["launches"]["chunk_fingerprint"]
    entry["policy_launches"] = policy["launches"]["quorum_local_max"]
    # the attrib phase: (a)'s workers under the gate, and (c)'s migration
    fp_entry["attrib_launches"] = attrib["launches"]["chunk_fingerprint"]
    fp_entry["attrib_migration_launches"] = attrib["dcp"]["fp_launches"]
    entry["attrib_launches"] = attrib["launches"]["quorum_local_max"]
    # the straggler phase's own run: its fused steps and its monitor's
    # ticks; then the ticks of the hang phase's native half
    entry["straggler_launches"] = straggler_a["launches"]
    entry["hang_native_launches"] = native_hang["local_max_launches"]
    # the mesh phase's own runs: (a)'s fused steps and save, (b)'s save per rank
    entry["mesh_launches"] = mesh["a"]["local_max_launches"]
    fp_entry["mesh_launches"] = mesh["a"]["fingerprint_launches"]
    fp_entry["mesh_2x2_launches_per_rank"] = [
        rk["fp_launches"] for rk in mesh["b"]["ranks"]]
    # the local phase's runs: (a)'s two peer-source saves, and the dryrun's
    # stage 2 (kernel 1) and stage 3 (kernel 2) in each of its four ranks
    fp_entry["local_peer_source_launches"] = local_a["peer_source"]["fp_launches"]
    fp_entry["local_dryrun_launches_per_rank"] = [
        r["launches"]["chunk_fingerprint"] for r in local_b["ranks"]]
    entry["local_dryrun_launches_per_rank"] = [
        r["launches"]["quorum_local_max"] for r in local_b["ranks"]]
    # the examples phase: advanced_example.py's tick lane (kernel 1); the
    # saves of async_ckpt.py and of train_with_launcher.py's cycle 1 (kernel 2)
    entry["examples_launches"] = {
        name: c.get("quorum_local_max", 0) for name, c in examples["launches"].items()}
    fp_entry["examples_launches"] = {
        name: c.get("chunk_fingerprint", 0) for name, c in examples["launches"].items()}
    # the soak phase: (a)'s workers, in their quorum tripwires' tick lanes
    entry["soak_launches"] = soak["kernel1_launches"]
    spin_entry = {
        "name": "device_spin",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/device_spin.cu",
        "replaces": "tpu_resiliency/utils/inject_fault.py:100",
        "launches": wedge["spin_launches"],
        # a program that never ends has no result, no time and no bound:
        # what is measured is the ring around it
        "max_abs_err": None,
        "ms": None,
        "plain_ms": None,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,
        "launch_to_soft_timeout_ms": wedge.get("launch_to_soft_timeout_ms"),
        "launch_to_kill_ms": wedge.get("launch_to_kill_ms"),
        "child_exit": wedge["rc"],
    }
    print(json.dumps({"wrap": {k: wrap[k] for k in ("faults", "launches", "steps",
                                                     "wall_s")}}))
    print(json.dumps({"injob": {k: v for k, v in injob.items() if k != "clean_losses"}}))
    print(json.dumps({"control": control}))
    print(json.dumps({"policy": policy}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"local": {"a": local_a, "b": local_b, "c": local_c}}))
    print(json.dumps({"straggler": {
        "a": {k: v for k, v in straggler_a.items() if k != "losses"},
        "b": {k: straggler_b[k] for k in ("sections", "devices", "flagged", "wall_s")},
        "hang_native": native_hang,
        "wedge_op_ring_read_while_wedged": wedge["op_ring_read_while_wedged"]}}))
    print(json.dumps({"attrib": {**attrib, "card": card}}))
    print(json.dumps({"examples": {**examples, "card": card}}))
    print(json.dumps({"soak": {**soak, "card": card}}))
    adamw_entry = {
        "name": "fused_adamw",
        "route": "cuda",
        "source": "tpu_resiliency_torch/ops/csrc/adamw.cu",
        # no Pallas kernel: XLA's fusion of the jitted update
        "replaces": "tpu_resiliency/models/transformer.py:208-215, 243",
        "launches": adamw_launches,
        "check_launches": check_launches,
        "mesh_launches": mesh["a"]["adamw_launches"],
        **{k: adamw_rec[k] for k in ("max_abs_err", "differing_elements", "ms",
                                     "ms_host", "plain_ms", "plain_ms_host",
                                     "bound_ms", "bound_by", "bound_share",
                                     "library_ms", "leaves", "params")},
    }
    print(json.dumps({"kernels": [entry, fp_entry, spin_entry, adamw_entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
