"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the fourteen CUDA kernels from cruise_control_torch/csrc,
     one nvcc per source, all at once;
  3. kernels: run each kernel on the card at the shapes the solves give it,
     on the smoke model's own state, and hold it against its plain PyTorch
     version run on a CPU copy of the same inputs (integers exact, floats
     bit-equal, finite masks exact); time each on the card over a run of
     back-to-back calls, as device time from a profiler trace and as time
     per call from CUDA events, and its plain version from CUDA events (K1,
     K2, K7, K8, K10 and window_sum beside the previous design's times,
     PREVIOUS_MS):
       K1 segment_aggregates (the smoke model, its bucketed service context's
       212,992 x 3 slots over 3,072 brokers, and the smoke model with half
       its slots on broker 0), K2 broker_topk (DiskCapacityGoal's drain
       priorities heaviest and lightest first, the relay's leadership-masked
       weights, and the bulk planner's priorities on the bucketed service
       context's 3,072 brokers), K3 score_candidates (each called with a
       round's packed ScoreContext: a hard goal's [512, 8, 64] drain grid,
       the [P, 2] promotion grid, a soft goal's drain grid, a drain wave's
       512-cell re-score and the grid round's all-broker re-score of 16
       entries against the bucketed context's 3,072 brokers, which take
       K3's factored, promotion, factored, general and promotion paths), K4
       apply_wave (a 1,024-entry drain wave, a
       2,600-entry two-leg relay wave and the bulk planner's wave, one entry
       per broker of the bucketed service context: 3,072; and its wave on a
       5,000-broker cluster bucketed to 5,120, K4's wide configuration), K5
       score_swaps with a round's context (the [128, 128, 8, 8] replica-swap
       grid on its staged path, a wave's re-validation of 128 swaps, the
       [512, 16, 8] topic-swap grid and the [512, 4, 2, 8, 2] relay grid), K6
       pair_picks (512 surplus pairs at k = 4 and 8), window_sum in XLA:CPU's order (the brokers'
       leader bytes-in, the [2,600, 4] broker loads, the 199,518
       partitions' leader bytes-in and the bucketed context's 3,072 brokers'
       leader bytes-in, each beside torch.sum), K7 state_fingerprint (the
       bucketed service context's aggregates over 3,072 brokers, the main
       path's shape, and the smoke model's over 2,600),
       K8 cluster_stats (the statistics of the smoke model, whose
       [4,000, 2,600] topic table is the work, and of its first 20 topics,
       whose mean takes TOPIC_LANES' order) and K9 grid_shortlist (the
       greedy round's [199,518, 3, 16] move grid and [199,518, 2] promotion
       grid under a hard goal with dead brokers and under
       LeaderReplicaDistributionGoal, beside K3 on the materialized grid
       followed by torch.argmax) and K10 delta_scatter (a 64-row batch of
       broker state changes, load spikes and partition adds, NOOP rows
       included, into the smoke model's bucketed context, 212,992 partitions
       by 3,072 brokers, and a random 4,096-row batch into the same), K3 and K9 with goal case 15
       (KafkaAssignerEvenRackAwareGoal) and with the only_move_immigrants
       flag set, and K11 elect_preferred (the smoke model's 199,518 rows with
       the demote phase's 26 demoted brokers and its 26 dead ones);
  4. hard goals: the self-healing proposal of the six hard goals through
     GoalOptimizer(device="cuda", settings=SLICE_SETTINGS + ledger);
  5. stack: the full 15-goal rebalance proposal through the fused stack,
     GoalOptimizer(device="cuda", settings=STACK_SETTINGS + ledger);
  6. service: the same proposal through the service's chunked goal machine
     with the provenance ledger and the cluster statistics at the exact
     shape, GoalOptimizer(device="cuda", settings=SERVICE_EXACT_SETTINGS);
  7. service hard goals: a hard-goal request through that machine (the
     full-stack machine with the six goals enabled), beside the fused stack
     run of the same six goals under STACK_SETTINGS + ledger;
  8. bench batched: BASELINE config 5 as bench.py builds it (2,600 brokers,
     199,518 partitions, exponential load, nothing cut) through the bench's
     batched pass, BENCH_SETTINGS: the chunked machine with 48 polish rounds
     and the ledger; the polish phases' skip tests must launch K7;
  9. parity: the bench's config-5 parity model (520 brokers, 52 racks, 800
     topics, RF 3, exponential load, seed 47) through the faithful-greedy
     pass, GREEDY_SETTINGS (the batch_k=1 grid, which must launch K9), and
     through BENCH_SETTINGS, held to bench.py's parity gate;
 10. service bucketed: the smoke model as the service solves it by default,
     SERVICE_SETTINGS, shape bucketing on (2,600 -> 3,072 brokers, 199,518 ->
     212,992 partitions, 4,000 -> 4,096 topics), its bucket record held to
     the JAX run's;
 11. bench bucketed: BASELINE config 5 under bench.py's default,
     BENCH_BUCKETED_SETTINGS;
 12. lane: an IncrementalLane armed on phase 10's solve proposes (a) a 4x
     load spike on one topic's partitions with 8 partitions added inside the
     bucket, then (b) one more dead broker; each proposal must launch K10
     and equal the JAX lane's digest, a scratch solve of the same goal subset
     on the card, with no move on the goals left out, and the armed prep
     entry must be unchanged after both. The lane's wall time is printed
     beside the scratch solve's.
 13-17. the options, each a JAX facade flow on the smoke model under
     SERVICE_SETTINGS (option_recipes): 13 self-healing (goal-violation
     options, the multiplier at 2.5), 14 decommission (26 more brokers dead,
     only immigrants move, 100 topics excluded), 15 demote (26 brokers
     demoted and excluded from leadership, LeaderReplicaDistributionGoal,
     then K11 on the initial and the final assignment, each output's
     SHA-256 held to JAX's), 16 destinations (26 NEW brokers the only
     destinations, 26 others excluded from replica moves), 17 kafka-assigner
     (the two kafka-assigner goals; K3's case 15 must launch). Replicas of
     excluded partitions may stay on dead brokers.
 18. monitored: the load monitor's path on the smoke model
     (monitored_model): a SimulatedCluster publishes every alive broker's
     metrics into an InMemoryTransport once a window, a LoadMonitor samples
     them for MONITOR_WINDOWS windows and builds the model under the
     facade's default requirements; every array of that model must equal the
     JAX monitor's (SHA-256, host numpy), then the service solve of it on the
     card (SERVICE_SETTINGS, pinned) is held to the JAX CPU run's digest; the
     host times of emission, sampling and model build, the solve's wall, the
     sensor registry's names and counts and the tracer's span kinds are
     printed.
 19. executed: phase 18's result named and stamped as the JAX facade does
     (stamp: topic-partition names, the monitor's generation, the topology
     fingerprint), then (a) executed by the port's Executor on a
     SimulatorClusterDriver of the simulator that emitted the metrics
     (LATENCY_POLLS polls a movement), under the monitor, with
     ExecutorConfig.from_config of the default configuration at a 10 ms poll
     (EXECUTION_CONFIG): the per-state counts, the validation's trims, the
     dispatch order (partitions per batch) and the simulator's assignment
     afterwards must equal the JAX executor's run of the JAX solve's
     proposals (JAX_CPU_EXECUTED), every task must complete, sampling must be
     paused at every dispatch and resumed after, and a second model build by
     the monitor must hold the executed assignment; (b) a ChaosHarness on a
     fresh simulator of the monitored model executes the same stamped
     proposals while the broker that receives the most added replicas dies at
     poll CHAOS_KILL_POLL: no invariant violation, the replication factor
     kept, and the counts and trims of the JAX run (JAX_CPU_CHAOS); (c) the
     host seconds of stamping, admission, execution and chaos are printed
     with the card's name and power limit. The executor is host Python and
     launches no kernel.
 20. self-healing (self_healing): on phase 19 (a)'s simulator and monitor,
     the service built as the JAX package's main.py builds it from a
     configuration (SELF_HEALING_CONFIG: `default.goals` trimmed to the two
     hard goals the smoke model can satisfy; OptimizerSettings.from_config
     on the card, the pinned schedule; a CruiseControl facade with
     IncrementalConfig.from_config; an Executor on a TcpClusterDriver to a
     FakeClusterAgent of the simulator on loopback, LATENCY_POLLS polls a
     movement, named_agent's row map), the alive
     broker that holds the most replicas is killed; an AnomalyDetector with a
     SelfHealingNotifier of the configuration's thresholds (broker-failure
     self-healing on) sweeps on a scripted clock and handles the anomaly the
     self-healing threshold later, so the ladder decides FIX at once:
     BrokerFailures.fix decommissions the broker through the facade, whose
     solve runs on the card (every kernel of its path must launch, its
     digest and final assignment equal the JAX run's) and whose execution
     crosses the wire; the anomalies, the decision, the fix counts, the
     goal-violation detector's silence while a broker is dead, and the
     execution's counts, trims, dispatch order and cluster afterwards must
     equal the JAX run's (JAX_CPU_SELF_HEALING), with no replica left on a
     dead broker. The host seconds of detection, model build, solve,
     stamping and execution are printed with the card's name and power
     limit.
 21. served (served): on phase 20's simulator and monitor, the service built
     from SELF_HEALING_CONFIG as the port's main.py builds it (the facade,
     AsyncCruiseControl, an AnomalyDetector, an Executor on a fresh
     TcpClusterDriver to named_agent), wrapped in the port's
     CruiseControlApp, served on loopback by its standard-library server and
     driven by the port's CruiseControlClient: GET state, load (2,600
     brokers' BrokerStats, K1 on the card), partition_load,
     kafka_cluster_state, proposals twice (the second from the cache), POST
     rebalance (a dry run of SERVED_GOALS), POST demote_broker of the broker
     leading the most partitions with dryrun=false (answered 202, then
     attached to until 200; its leadership moves execute over the wire),
     GET user_tasks, then /metrics and /perf. Every body less
     SERVED_VOLATILE, the three solves' digests and final assignments, the
     demote's execution and /metrics' sensor names must equal the JAX
     package's run of the same recipe (JAX_CPU_SERVED); each request's
     kernels (SERVED_PATHS) must launch; K11 on the demote's assignments
     must equal its plain version and JAX's election; /perf must name the
     card with a nonzero device-memory peak. Each request's host seconds
     are printed with the card's name and power limit.
 22. main (entry_point_phase): `python -m cruise_control_torch.main` as a
     subprocess on its default 12-broker simulated cluster, driven by
     `python -m cruise_control_torch.client.cccli` (state, proposals after
     the monitor's first window, rebalance --dryrun true): every command
     exits 0, the proposals replay with no replica on a dead broker, /perf
     names the card with a nonzero device-memory peak, /metrics counts a
     solve, and SIGINT stops the service within MAIN_SIGINT_S.
 23. mesh (mesh_phase): the partition-axis mesh, its shards row blocks of
     the one card: K12 shard_merge and K13 partition_stats against their
     plain versions (K12 on generated record sets, K13 on the smoke model
     padded to 199,520 rows, also against the host's counts) and timed; the
     sharded shortlist on 8 row blocks at the smoke model's full greedy grid
     equal to the unsharded K9; the parity model under GREEDY_SETTINGS on 4
     shards (K9 a shard and K12 a grid round) held to phase 9's JAX digest;
     the bucketed service solve on 8 shards held to phase 10's, K13's
     coverage certificate on its placed context, lane (a) under that mesh
     held to phase 12's; `make_mesh_from_config` refusing a mesh larger than
     the card count with the JAX package's message.
  Around each solve every kernel's launch count is set to 0 and read after
  (K3's and K5's also by path; the service bucketed solve must take all
  three of K3's);
  each kernel of the solve's path must have launched, and the result must
  hold: no replica left on a dead broker, no goal worse than before,
  sanity_check, the proposals replay to the final assignment. Each solve's
  per-goal table and its decision digest (the ledger's
  `digest(goals=<its goals>)`, with per-goal move counts) are printed beside
  the JAX package's CPU run of the same recipe; the digest and the final
  assignment's SHA-256 must equal the JAX run's (a difference names the
  first goal whose move count differs). The service solve's final assignment
  and touch tags must hash the same as the fused stack solve's, and the
  hard-goal request through the machine must equal its fused run.
The smoke model is BASELINE config 5's cluster (2,600 brokers, 52 racks,
4,000 topics, ~200k partitions at RF 3) with config 3's pareto load at mean
utilisation 0.5 and 26 dead brokers, from seed 42.

Phases 4-21 are held to the JAX package's runs of the same mode: JAX's
bucketed and exact runs differ on config 5 and on the smoke model. Every
chunked solve, here and in the JAX references, runs one pinned call
schedule (PINNED_TARGET_S).

The last lines are the total run time, the card's name and power limit, a
JSON object of per-kernel numbers and the final `{"ok": true, "device":
{...}}` line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: The card's memory rate and float32 rate outside the tensor cores (H100
#: SXM data sheet), for the bound. Integer and compare operations are
#: counted at the float32 rate too.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SEED = 42
#: calls before a timed run, and calls in it
WARMUP, REPS = 3, 30

#: The JAX package's run of the same recipe and settings on a CPU, printed
#: beside the card's numbers as the reference the port should reproduce:
#: goal -> (violated before, after, rounds, converged, cost before, after).
JAX_CPU_REFERENCE = {
    "RackAwareGoal": (0, 0, 37, True, 0.0, 0.0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "DiskCapacityGoal": (108, 30, 40, True, 5.69e7, 3.20e7),
    "NetworkInboundCapacityGoal": (143, 28, 64, False, 6.85e6, 3.83e6),
    "NetworkOutboundCapacityGoal": (11, 8, 13, True, 1.79e6, 1.66e6),
    "CpuCapacityGoal": (144, 42, 64, False, 12253.0, 5751.0),
}
JAX_CPU_MOVES = {"replica": 27630, "leadership": 1577}
#: The same for the full default stack with the stack settings.
JAX_CPU_STACK_REFERENCE = {
    **JAX_CPU_REFERENCE,
    "ReplicaDistributionGoal": (759, 258, 64, False, 2.506e4, 1.948e4),
    "PotentialNwOutGoal": (133, 41, 64, False, 7.651e6, 5.661e6),
    "DiskUsageDistributionGoal": (1881, 512, 64, False, 186.8, 81.56),
    "NetworkInboundUsageDistributionGoal": (1856, 905, 64, False, 191.2, 121.8),
    "NetworkOutboundUsageDistributionGoal": (2108, 188, 64, False, 130.0, 46.37),
    "CpuUsageDistributionGoal": (1847, 400, 64, False, 196.7, 84.93),
    "TopicReplicaDistributionGoal": (2496, 1318, 64, False, 1.764e4, 6986.0),
    "LeaderReplicaDistributionGoal": (1430, 978, 38, True, 2.678e4, 2.273e4),
    "LeaderBytesInDistributionGoal": (798, 600, 64, False, 7.063e6, 6.047e6),
}
JAX_CPU_STACK_MOVES = {"replica": 50949, "leadership": 19618}
#: The decision digests of the JAX package's CPU runs of the same recipes
#: (provenance `digest(goals=<the solve's goals>)`: the checksum and the
#: per-goal move counts) and the SHA-256 of their final assignments. The
#: chunked service run gives the fused stack's digest and assignment.
#: tests/test_torch_service.py::test_chip_smoke_jax_references_are_current
#: recomputes them (slow lane).
_JAX_STACK_MOVES_BY_GOAL = {
    "RackAwareGoal": 6006, "DiskCapacityGoal": 7813, "NetworkInboundCapacityGoal": 6941,
    "NetworkOutboundCapacityGoal": 992, "CpuCapacityGoal": 11225,
    "ReplicaDistributionGoal": 4979, "PotentialNwOutGoal": 878,
    "DiskUsageDistributionGoal": 3228, "NetworkInboundUsageDistributionGoal": 2056,
    "NetworkOutboundUsageDistributionGoal": 26242, "CpuUsageDistributionGoal": 19252,
    "TopicReplicaDistributionGoal": 10655, "LeaderReplicaDistributionGoal": 5765,
    "LeaderBytesInDistributionGoal": 2395,
}
_JAX_STACK_DIGEST = ("e00e2cfa47d76bd9", _JAX_STACK_MOVES_BY_GOAL,
                     "b72d5d8924b4f769028da5108523775a5edb35d2e81c9d593e8187e0a90bac25")
JAX_CPU_DIGESTS = {
    "hard goals": ("97d90cc1f14cd990",
                   {k: _JAX_STACK_MOVES_BY_GOAL[k] for k in (
                       "RackAwareGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
                       "NetworkOutboundCapacityGoal", "CpuCapacityGoal")},
                   "ef2dcbf188952fb1293ccfb5e8f1bdc9ac5a3c8c8954f2ea72b21f788c881879"),
    "stack": _JAX_STACK_DIGEST,
    "service": _JAX_STACK_DIGEST,
}
# a hard-goal request through the service's machine, and the fused stack run
# of the six goals under the stack settings, make the same decisions
JAX_CPU_DIGESTS["service hard goals"] = JAX_CPU_DIGESTS["stack hard goals"] = \
    JAX_CPU_DIGESTS["hard goals"]
#: The JAX package's CPU runs of the slice-3b solves, with bench.py's
#: settings and shape bucketing off (goal -> the same six columns; the
#: digests as above, with the moves of each solve: replica, leadership).
#: Phase 8: BASELINE config 5 under BENCH_SETTINGS.
JAX_CPU_BENCH_REFERENCE = {
    "RackAwareGoal": (0, 0, 2, True, 0.0, 0.0),
    "ReplicaCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "DiskCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "NetworkInboundCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "NetworkOutboundCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "CpuCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "ReplicaDistributionGoal": (424, 0, 10, True, 3101, 0.0),
    "PotentialNwOutGoal": (0, 0, 2, True, 0.0, 0.0),
    "DiskUsageDistributionGoal": (876, 0, 13, True, 15.68, 0.0),
    "NetworkInboundUsageDistributionGoal": (681, 0, 12, True, 9.969, 0.0),
    "NetworkOutboundUsageDistributionGoal": (1475, 0, 10, True, 17.44, 0.0),
    "CpuUsageDistributionGoal": (753, 0, 8, True, 10.85, 0.0),
    "TopicReplicaDistributionGoal": (2598, 0, 73, True, 1.683e+04, 0.0),
    "LeaderReplicaDistributionGoal": (543, 5, 24, True, 1833, 11),
    "LeaderBytesInDistributionGoal": (570, 40, 19, True, 4.946e+05, 3.161e+04),
}
#: Phase 9: the config-5 parity model under GREEDY_SETTINGS and BENCH_SETTINGS.
JAX_CPU_PARITY_GREEDY_REFERENCE = {
    "RackAwareGoal": (0, 0, 1, True, 0.0, 0.0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "DiskCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "NetworkInboundCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "NetworkOutboundCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "CpuCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "ReplicaDistributionGoal": (83, 0, 72, True, 605, 0.0),
    "PotentialNwOutGoal": (0, 0, 1, True, 0.0, 0.0),
    "DiskUsageDistributionGoal": (176, 0, 6, True, 2.998, 0.0),
    "NetworkInboundUsageDistributionGoal": (163, 0, 3, True, 2.445, 0.0),
    "NetworkOutboundUsageDistributionGoal": (304, 0, 3, True, 2.956, 0.0),
    "CpuUsageDistributionGoal": (147, 0, 4, True, 2.17, 0.0),
    "TopicReplicaDistributionGoal": (520, 1, 127, True, 1.438e+04, 4),
    "LeaderReplicaDistributionGoal": (130, 1, 63, True, 471, 1),
    "LeaderBytesInDistributionGoal": (126, 1, 18, True, 1.148e+05, 215.9),
}
JAX_CPU_PARITY_BATCHED_REFERENCE = {
    "RackAwareGoal": (0, 0, 2, True, 0.0, 0.0),
    "ReplicaCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "DiskCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "NetworkInboundCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "NetworkOutboundCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "CpuCapacityGoal": (0, 0, 2, True, 0.0, 0.0),
    "ReplicaDistributionGoal": (83, 0, 9, True, 605, 0.0),
    "PotentialNwOutGoal": (0, 0, 2, True, 0.0, 0.0),
    "DiskUsageDistributionGoal": (177, 0, 6, True, 3.121, 0.0),
    "NetworkInboundUsageDistributionGoal": (161, 0, 4, True, 2.43, 0.0),
    "NetworkOutboundUsageDistributionGoal": (310, 0, 4, True, 3.007, 0.0),
    "CpuUsageDistributionGoal": (148, 0, 5, True, 2.146, 0.0),
    "TopicReplicaDistributionGoal": (520, 0, 110, True, 1.432e+04, 0.0),
    "LeaderReplicaDistributionGoal": (128, 0, 6, True, 499, 0.0),
    "LeaderBytesInDistributionGoal": (129, 3, 11, True, 1.114e+05, 1126),
}
JAX_CPU_DIGESTS["bench batched"] = (
    "b533e5d13b306bb3", {
        "ReplicaDistributionGoal": 1745, "DiskUsageDistributionGoal": 1573,
        "NetworkInboundUsageDistributionGoal": 1073, "NetworkOutboundUsageDistributionGoal": 3124,
        "CpuUsageDistributionGoal": 1798, "TopicReplicaDistributionGoal": 17239,
        "LeaderReplicaDistributionGoal": 1283, "LeaderBytesInDistributionGoal": 1327,
    },
    "457c6e7966f46040e49acad46cd96a0321e673dd5e24b3c4390fae356efe7449")
JAX_CPU_DIGESTS["parity greedy"] = (
    "dda7924d6e3ff34c", {
        "ReplicaDistributionGoal": 392, "DiskUsageDistributionGoal": 307,
        "NetworkInboundUsageDistributionGoal": 237, "NetworkOutboundUsageDistributionGoal": 543,
        "CpuUsageDistributionGoal": 319, "TopicReplicaDistributionGoal": 14605,
        "LeaderReplicaDistributionGoal": 364, "LeaderBytesInDistributionGoal": 328,
    },
    "a21e5093d1bb315f17f1c2859c74211a14966604db1224e8f14070de45dcf5bd")
JAX_CPU_DIGESTS["parity batched"] = (
    "14e910fe5f279f2e", {
        "ReplicaDistributionGoal": 392, "DiskUsageDistributionGoal": 310,
        "NetworkInboundUsageDistributionGoal": 237, "NetworkOutboundUsageDistributionGoal": 556,
        "CpuUsageDistributionGoal": 325, "TopicReplicaDistributionGoal": 14556,
        "LeaderReplicaDistributionGoal": 398, "LeaderBytesInDistributionGoal": 320,
    },
    "957b2f746e3efc4771e72684cd26152e5a02c2b31fb9c806c8891c2c830fc0ec")
#: Phase 11: bench.py's default, with shape bucketing, makes other decisions
#: on config 5 than the exact-shape run (LeaderReplicaDistributionGoal: 23
#: rounds, not 24; ROADMAP.md Queue 3): each phase is held to its own mode
JAX_CPU_DIGESTS["bench bucketed"] = (
    "1457d341e23f5a8e", JAX_CPU_DIGESTS["bench batched"][1],
    "806dd3fe8702428b368ec72e8cc5c0c90a1d23652ff2b6aa74748051647bbdf0")
JAX_CPU_BENCH_BUCKETED_REFERENCE = dict(
    JAX_CPU_BENCH_REFERENCE, LeaderReplicaDistributionGoal=(543, 5, 23, True, 1833, 11))
JAX_CPU_BENCH_BUCKETED_MOVES = {"replica": 24356, "leadership": 1955}
JAX_CPU_BENCH_MOVES = {"replica": 24356, "leadership": 1955}
JAX_CPU_PARITY_GREEDY_MOVES = {"replica": 15916, "leadership": 313}
JAX_CPU_PARITY_BATCHED_MOVES = {"replica": 15896, "leadership": 325}
#: Phase 23: the mesh's solves pad nothing, so they are held to phases 9, 10
#: and 12's constants; the JAX package's own mesh-4 greedy run of the parity
#: model on 4 virtual CPU devices makes phase 9's decisions too
#: (scripts/executor_references.py --mesh).
JAX_CPU_DIGESTS["mesh parity greedy"] = JAX_CPU_DIGESTS["parity greedy"]
#: Phases 10 and 12: the smoke model under SERVICE_SETTINGS (shape bucketing
#: on), then the lane armed on that solve: (a) lane_perturbations' load spike and partition adds, (b)
#: one more dead broker. JAX's bucketed service run decides otherwise than
#: its exact one (LeaderReplicaDistributionGoal: 36 rounds, not 38;
#: ROADMAP.md Queue 3).
JAX_CPU_SERVICE_BUCKETED_REFERENCE = {
    "RackAwareGoal": (0, 0, 37, True, 0, 0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
    "DiskCapacityGoal": (108, 30, 40, True, 5.69e+07, 3.202e+07),
    "NetworkInboundCapacityGoal": (143, 28, 64, False, 6.852e+06, 3.834e+06),
    "NetworkOutboundCapacityGoal": (11, 8, 13, True, 1.791e+06, 1.659e+06),
    "CpuCapacityGoal": (144, 42, 64, False, 1.225e+04, 5751),
    "ReplicaDistributionGoal": (759, 258, 64, False, 2.506e+04, 1.948e+04),
    "PotentialNwOutGoal": (133, 41, 64, False, 7.651e+06, 5.661e+06),
    "DiskUsageDistributionGoal": (1881, 512, 64, False, 186.8, 81.56),
    "NetworkInboundUsageDistributionGoal": (1856, 905, 64, False, 191.2, 121.8),
    "NetworkOutboundUsageDistributionGoal": (2108, 188, 64, False, 130, 46.38),
    "CpuUsageDistributionGoal": (1847, 405, 64, False, 196.7, 85.11),
    "TopicReplicaDistributionGoal": (2496, 1339, 64, False, 1.764e+04, 6968),
    "LeaderReplicaDistributionGoal": (1437, 964, 36, True, 2.684e+04, 2.283e+04),
    "LeaderBytesInDistributionGoal": (798, 610, 64, False, 7.065e+06, 6.108e+06),
}
JAX_CPU_DIGESTS["service bucketed"] = (
    "f0af5bad00562541", {
        "RackAwareGoal": 6006, "DiskCapacityGoal": 7813,
        "NetworkInboundCapacityGoal": 6941, "NetworkOutboundCapacityGoal": 992,
        "CpuCapacityGoal": 11225, "ReplicaDistributionGoal": 4979,
        "PotentialNwOutGoal": 878, "DiskUsageDistributionGoal": 3228,
        "NetworkInboundUsageDistributionGoal": 2056, "NetworkOutboundUsageDistributionGoal": 26245,
        "CpuUsageDistributionGoal": 19736, "TopicReplicaDistributionGoal": 10668,
        "LeaderReplicaDistributionGoal": 5664, "LeaderBytesInDistributionGoal": 2389,
    },
    "faad461ec077fed3e42668414d23d0ba01cfb77b956a5f370a8c70b1f81f9b04")
JAX_CPU_SERVICE_BUCKETED_MOVES = {"replica": 50991, "leadership": 19745}
JAX_CPU_SERVICE_BUCKETED_BLOCK = {
    "exact": {"num_partitions": 199518, "max_rf": 3, "num_brokers": 2600, "num_racks": 52,
              "num_hosts": 2600, "num_topics": 4000},
    "padded": {"num_partitions": 212992, "max_rf": 3, "num_brokers": 3072, "num_racks": 52,
               "num_hosts": 3072, "num_topics": 4096},
    "bucket": "P212992-B3072-T4096-RF3", "paddedPartitions": 13474, "paddedBrokers": 472,
}
JAX_CPU_LANE_A_REFERENCE = {
    "RackAwareGoal": (2, 0, 37, True, 2, 0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
    "DiskCapacityGoal": (113, 30, 40, True, 5.784e+07, 3.202e+07),
    "NetworkInboundCapacityGoal": (144, 24, 58, True, 6.872e+06, 3.83e+06),
    "NetworkOutboundCapacityGoal": (11, 8, 12, True, 1.785e+06, 1.659e+06),
    "CpuCapacityGoal": (147, 42, 64, False, 1.213e+04, 5738),
    "ReplicaDistributionGoal": (738, 255, 64, False, 2.525e+04, 1.928e+04),
    "PotentialNwOutGoal": (134, 42, 64, False, 7.628e+06, 5.638e+06),
    "DiskUsageDistributionGoal": (1893, 775, 64, False, 186.8, 98.01),
    "NetworkInboundUsageDistributionGoal": (1864, 1064, 64, False, 191.3, 128.1),
    "NetworkOutboundUsageDistributionGoal": (2118, 187, 64, False, 129.4, 46.39),
    "CpuUsageDistributionGoal": (1830, 373, 64, False, 194.3, 82.1),
    "TopicReplicaDistributionGoal": (2495, 1500, 64, False, 1.768e+04, 7742),
    "LeaderReplicaDistributionGoal": (1459, 1028, 49, True, 2.777e+04, 2.301e+04),
    "LeaderBytesInDistributionGoal": (781, 605, 64, False, 7.202e+06, 6.267e+06),
}
JAX_CPU_DIGESTS["lane a"] = (
    "8d45aa7713ab4923", {
        "RackAwareGoal": 6007, "DiskCapacityGoal": 7874,
        "NetworkInboundCapacityGoal": 6987, "NetworkOutboundCapacityGoal": 918,
        "CpuCapacityGoal": 11436, "ReplicaDistributionGoal": 5270,
        "PotentialNwOutGoal": 912, "DiskUsageDistributionGoal": 2683,
        "NetworkInboundUsageDistributionGoal": 1784, "NetworkOutboundUsageDistributionGoal": 27082,
        "CpuUsageDistributionGoal": 22328, "TopicReplicaDistributionGoal": 9936,
        "LeaderReplicaDistributionGoal": 6808, "LeaderBytesInDistributionGoal": 2305,
    },
    "361ae1aac6bc035484a1d876ecef149240d5a630c29bca0fdfbd55bc6231bb42")
JAX_CPU_LANE_A_MOVES = {"replica": 50064, "leadership": 21025}
JAX_CPU_LANE_B_REFERENCE = {
    "RackAwareGoal": (2, 0, 37, True, 2, 0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
    "DiskCapacityGoal": (113, 30, 39, True, 5.78e+07, 3.202e+07),
    "NetworkInboundCapacityGoal": (144, 24, 64, False, 6.898e+06, 3.83e+06),
    "NetworkOutboundCapacityGoal": (11, 8, 12, True, 1.797e+06, 1.659e+06),
    "CpuCapacityGoal": (144, 42, 64, False, 1.218e+04, 5744),
    "ReplicaDistributionGoal": (719, 257, 64, False, 2.4e+04, 1.867e+04),
    "PotentialNwOutGoal": (140, 45, 64, False, 7.594e+06, 5.716e+06),
    "DiskUsageDistributionGoal": (1892, 762, 64, False, 185.1, 95.83),
    "NetworkInboundUsageDistributionGoal": (1834, 1067, 64, False, 189.6, 131.6),
    "NetworkOutboundUsageDistributionGoal": (2138, 185, 64, False, 129.6, 46.18),
    "CpuUsageDistributionGoal": (1829, 370, 64, False, 193.8, 83.04),
    "TopicReplicaDistributionGoal": (2499, 1473, 64, False, 1.761e+04, 7614),
    "LeaderReplicaDistributionGoal": (1427, 990, 43, True, 2.636e+04, 2.21e+04),
    "LeaderBytesInDistributionGoal": (763, 591, 64, False, 7.078e+06, 6.083e+06),
}
JAX_CPU_DIGESTS["lane b"] = (
    "656c7c5086b42715", {
        "RackAwareGoal": 6293, "DiskCapacityGoal": 7860,
        "NetworkInboundCapacityGoal": 6967, "NetworkOutboundCapacityGoal": 1033,
        "CpuCapacityGoal": 10838, "ReplicaDistributionGoal": 4743,
        "PotentialNwOutGoal": 800, "DiskUsageDistributionGoal": 2740,
        "NetworkInboundUsageDistributionGoal": 1605, "NetworkOutboundUsageDistributionGoal": 26333,
        "CpuUsageDistributionGoal": 20086, "TopicReplicaDistributionGoal": 9995,
        "LeaderReplicaDistributionGoal": 6294, "LeaderBytesInDistributionGoal": 2489,
    },
    "f34bf71fa6a72713ec7edb9cd332d84a68e46dbc0854c4a574d408e2480980d6")
JAX_CPU_LANE_B_MOVES = {"replica": 48901, "leadership": 20175}
JAX_CPU_DIGESTS["mesh service bucketed"] = JAX_CPU_DIGESTS["service bucketed"]
JAX_CPU_DIGESTS["mesh lane a"] = JAX_CPU_DIGESTS["lane a"]
#: the option phases (13-17): JAX's CPU runs of option_recipes under the
#: pinned SERVICE_SETTINGS: each goal's row, the moves, the decision digest
#: with per-goal move counts and the final assignment's SHA-256
JAX_CPU_OPTION_REFERENCE = {
    "self-healing": {
        "RackAwareGoal": (0, 0, 37, True, 0, 0),
        "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
        "DiskCapacityGoal": (108, 30, 40, True, 5.69e+07, 3.202e+07),
        "NetworkInboundCapacityGoal": (143, 28, 64, False, 6.852e+06, 3.834e+06),
        "NetworkOutboundCapacityGoal": (11, 8, 13, True, 1.791e+06, 1.659e+06),
        "CpuCapacityGoal": (144, 42, 64, False, 1.225e+04, 5751),
        "ReplicaDistributionGoal": (126, 97, 9, True, 1.465e+04, 1.44e+04),
        "PotentialNwOutGoal": (135, 41, 64, False, 7.65e+06, 5.414e+06),
        "DiskUsageDistributionGoal": (771, 91, 64, False, 96.02, 57.38),
        "NetworkInboundUsageDistributionGoal": (744, 129, 64, False, 103.8, 67.34),
        "NetworkOutboundUsageDistributionGoal": (1407, 174, 64, False, 91.43, 41.6),
        "CpuUsageDistributionGoal": (837, 161, 64, False, 106, 62.7),
        "TopicReplicaDistributionGoal": (2493, 94, 64, False, 1.776e+04, 267),
        "LeaderReplicaDistributionGoal": (480, 250, 25, True, 1.348e+04, 1.227e+04),
        "LeaderBytesInDistributionGoal": (483, 149, 53, True, 5.575e+06, 3.691e+06),
    },
    "decommission": {
        "RackAwareGoal": (0, 0, 38, True, 0, 0),
        "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
        "DiskCapacityGoal": (108, 108, 1, True, 5.67e+07, 5.67e+07),
        "NetworkInboundCapacityGoal": (136, 136, 1, True, 6.722e+06, 6.722e+06),
        "NetworkOutboundCapacityGoal": (11, 11, 1, True, 1.797e+06, 1.797e+06),
        "CpuCapacityGoal": (138, 138, 1, True, 1.192e+04, 1.192e+04),
        "ReplicaDistributionGoal": (423, 423, 1, True, 3837, 3837),
        "PotentialNwOutGoal": (131, 131, 1, True, 7.536e+06, 7.536e+06),
        "DiskUsageDistributionGoal": (1861, 1861, 1, True, 207.2, 207.2),
        "NetworkInboundUsageDistributionGoal": (1825, 1825, 1, True, 215.1, 215.1),
        "NetworkOutboundUsageDistributionGoal": (2136, 2136, 1, True, 125.8, 125.8),
        "CpuUsageDistributionGoal": (1838, 1838, 1, True, 211.7, 211.7),
        "TopicReplicaDistributionGoal": (2547, 2547, 8, True, 1.727e+04, 1.727e+04),
        "LeaderReplicaDistributionGoal": (975, 975, 8, True, 5334, 5334),
        "LeaderBytesInDistributionGoal": (573, 573, 8, True, 6.696e+06, 6.696e+06),
    },
    "demote": {
        "LeaderReplicaDistributionGoal": (952, 0, 37, True, 5118, 0),
    },
    "destinations": {
        "RackAwareGoal": (0, 0, 54, True, 0, 0),
        "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
        "DiskCapacityGoal": (128, 126, 2, True, 6.189e+07, 6.185e+07),
        "NetworkInboundCapacityGoal": (157, 157, 2, True, 7.15e+06, 7.137e+06),
        "NetworkOutboundCapacityGoal": (11, 8, 22, True, 1.806e+06, 1.66e+06),
        "CpuCapacityGoal": (160, 83, 31, True, 1.288e+04, 9448),
        "ReplicaDistributionGoal": (452, 452, 1, True, 8274, 8274),
        "PotentialNwOutGoal": (142, 142, 1, True, 7.841e+06, 7.841e+06),
        "DiskUsageDistributionGoal": (1968, 1968, 1, True, 234.6, 234.6),
        "NetworkInboundUsageDistributionGoal": (1953, 1953, 2, True, 240.5, 240.5),
        "NetworkOutboundUsageDistributionGoal": (2142, 207, 46, True, 133.5, 48.72),
        "CpuUsageDistributionGoal": (1956, 1393, 32, True, 223.7, 162.2),
        "TopicReplicaDistributionGoal": (2572, 2572, 8, True, 1.721e+04, 1.721e+04),
        "LeaderReplicaDistributionGoal": (1607, 1582, 19, True, 2.744e+04, 2.678e+04),
        "LeaderBytesInDistributionGoal": (723, 723, 19, True, 7.747e+06, 7.739e+06),
    },
    "kafka-assigner": {
        "KafkaAssignerEvenRackAwareGoal": (2433, 350, 54, True, 3.044e+04, 532),
        "KafkaAssignerDiskUsageDistributionGoal": (1948, 1313, 64, False, 220.6, 124.9),
    },
}
JAX_CPU_OPTION_MOVES = {
    "self-healing": {"replica": 54257, "leadership": 10868},
    "decommission": {"replica": 11709, "leadership": 0},
    "demote": {"replica": 7952, "leadership": 376},
    "destinations": {"replica": 6016, "leadership": 31499},
    "kafka-assigner": {"replica": 20115, "leadership": 0},
}
JAX_CPU_DIGESTS["self-healing"] = (
    "0b8f866932149477", {
        "RackAwareGoal": 6006, "DiskCapacityGoal": 7813, "NetworkInboundCapacityGoal": 6941,
        "NetworkOutboundCapacityGoal": 992, "CpuCapacityGoal": 11225,
        "ReplicaDistributionGoal": 249, "PotentialNwOutGoal": 1469,
        "DiskUsageDistributionGoal": 2477, "NetworkInboundUsageDistributionGoal": 2354,
        "NetworkOutboundUsageDistributionGoal": 17998, "CpuUsageDistributionGoal": 5701,
        "TopicReplicaDistributionGoal": 17742, "LeaderReplicaDistributionGoal": 2158,
        "LeaderBytesInDistributionGoal": 4793,
    },
    "6bfeee8582bac7e7eff44c33732ee3b856ae0926e438d3292e6ae6e72d2e53b8")
JAX_CPU_DIGESTS["decommission"] = (
    "6602e47d3f7c3723", {
        "RackAwareGoal": 11709,
    },
    "c49b1a171f8ea3bd48c827b5687b871bbf7c4b2f7ab6da9e26c01005e4403502")
JAX_CPU_DIGESTS["demote"] = (
    "c0acc01fcacbf536", {
        "LeaderReplicaDistributionGoal": 8711,
    },
    "b465ee127bcae76116c264c109211f2a95cebbfee30be7009c1ff4b0dae949ac")
JAX_CPU_DIGESTS["destinations"] = (
    "8ced8bc115318c3d", {
        "RackAwareGoal": 6006, "DiskCapacityGoal": 3, "NetworkInboundCapacityGoal": 3,
        "NetworkOutboundCapacityGoal": 1380, "CpuCapacityGoal": 15402,
        "NetworkInboundUsageDistributionGoal": 2, "NetworkOutboundUsageDistributionGoal": 29069,
        "CpuUsageDistributionGoal": 21430, "LeaderReplicaDistributionGoal": 1268,
        "LeaderBytesInDistributionGoal": 52,
    },
    "b7af77753a1d8ac438e8a9014421056a57ab7fcb8f32298be9bff3bee1d69efd")
JAX_CPU_DIGESTS["kafka-assigner"] = (
    "bd5a0e7c80733647", {
        "KafkaAssignerEvenRackAwareGoal": 18374, "KafkaAssignerDiskUsageDistributionGoal": 1844,
    },
    "b13cbc19d0b02545f331968060b38218a1d8b3f5ef81b2e6ad4a95b005c9049e")
#: K11 in the demote phase: the SHA-256 of JAX's elect_preferred_leaders
#: of the demoted model's initial and final assignments
JAX_CPU_K11_SHA256 = {"initial": "796f7442ade0f78ec4b88d3e030d73a9b31bd911643f13623e79f6312f8df3b0",
                      "final": "e8db5ea8b9a078bd47b4d7f2f9ffe555a2ac7fefd202061d7a2a5fec47b30a6b"}
#: Phase 18: the smoke model's metrics through the load monitor (monitored_model:
#: MONITOR_WINDOWS windows of LoadMonitorConfig(), the facade's default
#: requirements), then the service solve (SERVICE_SETTINGS, pinned) of the
#: monitored model: the JAX monitor's model (each field's SHA-256) and the JAX
#: CPU run of that solve.
JAX_CPU_MONITORED_MODEL_SHA256 = {
    "assignment": "490b9400173b272cd7c18ac799e957b71ca5add1cceadbbecdc4cdcf4c981144",
    "part_load": "4ecf44761f2b0f9bbb12ecd52ea3bcbca24ebfa445382c0bf445a64cacbe7a34",
    "topic_id": "cba1f20666b904dceb56216397ce4720e6070c14a31aacb1493e853c49d68488",
    "broker_capacity": "e4b6cff8d053e2ffb078e254f904e142145b834cac0e1c6e8d155536f1c901cf",
    "broker_rack": "6620932676efb027c46e7826760abd2a044cc219636461aa86cbc4e81e1610b0",
    "broker_host": "46738181cf1bf5359008200a556c9561270ce89b42a8dc45d345d24230db60b0",
    "broker_state": "5f2e86732a874f47361b6541ffb1dd2a37a8e7774f499da8f7ef4af5636f9f97",
}
JAX_CPU_MONITORED_REFERENCE = {
    "RackAwareGoal": (0, 0, 37, True, 0, 0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0, 0),
    "DiskCapacityGoal": (105, 30, 39, True, 5.577e+07, 3.202e+07),
    "NetworkInboundCapacityGoal": (139, 24, 56, True, 6.805e+06, 3.83e+06),
    "NetworkOutboundCapacityGoal": (10, 7, 12, True, 1.64e+06, 1.517e+06),
    "CpuCapacityGoal": (131, 4, 45, True, 8547, 297.9),
    "ReplicaDistributionGoal": (633, 137, 64, False, 1.971e+04, 1.326e+04),
    "PotentialNwOutGoal": (127, 38, 64, False, 6.903e+06, 5.148e+06),
    "DiskUsageDistributionGoal": (1893, 596, 64, False, 178.7, 78.52),
    "NetworkInboundUsageDistributionGoal": (1857, 897, 64, False, 183.4, 112.8),
    "NetworkOutboundUsageDistributionGoal": (2116, 217, 64, False, 125.1, 42.77),
    "CpuUsageDistributionGoal": (1764, 540, 27, True, 171.1, 74.52),
    "TopicReplicaDistributionGoal": (2515, 1355, 64, False, 1.749e+04, 6285),
    "LeaderReplicaDistributionGoal": (1248, 694, 37, True, 1.89e+04, 1.484e+04),
    "LeaderBytesInDistributionGoal": (766, 595, 60, True, 6.489e+06, 5.708e+06),
}
JAX_CPU_DIGESTS["monitored"] = (
    "99518476c2eab44e", {
        "RackAwareGoal": 6006, "DiskCapacityGoal": 7690, "NetworkInboundCapacityGoal": 6945,
        "NetworkOutboundCapacityGoal": 891, "CpuCapacityGoal": 1960,
        "ReplicaDistributionGoal": 5164, "PotentialNwOutGoal": 782,
        "DiskUsageDistributionGoal": 2961, "NetworkInboundUsageDistributionGoal": 1936,
        "NetworkOutboundUsageDistributionGoal": 26389, "CpuUsageDistributionGoal": 9481,
        "TopicReplicaDistributionGoal": 11206, "LeaderReplicaDistributionGoal": 5849,
        "LeaderBytesInDistributionGoal": 3235,
    },
    "ba223496d447d46fa9c9e252794364e3907fe7cb39981124f1f509bd28d3cfd7")
JAX_CPU_MONITORED_MOVES = {"replica": 43143, "leadership": 16951}
#: Phase 19: phase 18's JAX solve stamped (stamp), executed by the JAX
#: executor on the simulator that emitted the metrics (execute_monitored),
#: and a chaos run of the same proposals that kills broker 223 at poll 2
#: (chaos_run): each run's execution_record
JAX_CPU_EXECUTED = {
    "numTotalMovements": 55884,
    "numFinishedMovements": 55884,
    "numInProgressMovements": 0,
    "numAbortedOrDead": 0,
    "byState": {
        "PENDING": 0, "IN_PROGRESS": 0, "ABORTING": 0, "ABORTED": 0,
        "DEAD": 0, "COMPLETED": 55884},
    "stopped": False,
    "failedTasks": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
    "admitted": 55884,
    "numTrimmed": 0,
    "trimmedByReason": {},
    "aborted": False,
    "generationSkew": 0,
    "batchRevalidations": 43,
    "trimmed": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
    "batches": 44,
    "dispatchSha256": "5c83d05647043ebbab25921bef66bbd1fe0188f6847591f5e65c7505c90b7a2b",
    "assignmentSha256": "d48809b5f5b417c8804c20d0cfa1ff2da27df2c43e6547101e7a4f175bfc634f",
}
JAX_CPU_CHAOS = {
    "numTotalMovements": 55884,
    "numFinishedMovements": 55884,
    "numInProgressMovements": 0,
    "numAbortedOrDead": 89,
    "byState": {
        "PENDING": 0, "IN_PROGRESS": 0, "ABORTING": 0, "ABORTED": 89,
        "DEAD": 0, "COMPLETED": 55795},
    "stopped": False,
    "failedTasks": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
    "admitted": 55884,
    "numTrimmed": 89,
    "trimmedByReason": {"DEST_DEAD": 89},
    "aborted": False,
    "generationSkew": 1,
    "batchRevalidations": 65,
    "trimmed": "9343aadf88e81c5a7a1dfe36d53acb9ae429f6fe4e7832dfccd8ec633c6de62e",
    "assignmentSha256": "45abc42587cd4b27f63e49f2953aa9d683fcdd54209dd84bdc6db25745873f0e",
}
#: Phase 20: chip_smoke.self_healing on the JAX package after phase 19 (a):
#: the victim, the detector's anomalies, decision and fix counts, the
#: decommission's moves and its execution over the TCP wire
#: (self_healing_record), then the decommission solve's digest and goal rows
JAX_CPU_SELF_HEALING = {
    "victim": 176,
    "queued": 1,
    "detected": [{"anomalyType": "BROKER_FAILURE", "failedBrokers": {"176": 7200000}}],
    "action": "FIX",
    "fixesTriggered": {"GOAL_VIOLATION": 0, "BROKER_FAILURE": 1, "METRIC_ANOMALY": 0},
    "fixFailures": {"GOAL_VIOLATION": 0, "BROKER_FAILURE": 0, "METRIC_ANOMALY": 0},
    "moves": {"replica": 302, "leadership": 0},
    "executed": {
        "numTotalMovements": 302,
        "numFinishedMovements": 302,
        "numInProgressMovements": 0,
        "numAbortedOrDead": 0,
        "byState": {"PENDING": 0, "IN_PROGRESS": 0, "ABORTING": 0, "ABORTED": 0, "DEAD": 0,
                    "COMPLETED": 302},
        "stopped": False,
        "failedTasks": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "admitted": 302,
        "numTrimmed": 0,
        "trimmedByReason": {},
        "aborted": False,
        "generationSkew": 0,
        "batchRevalidations": 30,
        "trimmed": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "batches": 31,
        "dispatchSha256": "bd93d09a10d1dbf607020d15dec01e74481250d0b19bdfd6de863baeb6e23cb4",
        "assignmentSha256": "85eea2e06ea42159987ea887ea84eaedb8adf9d5246f4c8c1c48fd5eb2e96492",
    },
}
JAX_CPU_DIGESTS["broker failure"] = (
    "97daf219525b7620", {"RackAwareGoal": 302},
    "85eea2e06ea42159987ea887ea84eaedb8adf9d5246f4c8c1c48fd5eb2e96492")
JAX_CPU_SELF_HEALING_REFERENCE = {
    "RackAwareGoal": (0, 0, 38, True, 0.0, 0.0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
}
#: Phase 21: chip_smoke.served on the JAX package after phase 20, its aiohttp
#: server driven by its client (scripts/executor_references.py --no-chaos
#: --served): the record (served_record), then each solve's digest, goal
#: rows and moves, and JAX's elect_preferred_leaders on the demote's
#: initial and final assignments
JAX_CPU_SERVED = {
    "bodies": {
        "state": "790356d2bcf950b6f9552a4edf4cf3e64c74ae56ec7e065b44e818a929580e66",
        "load": "865a41ed78a023333ac38329a8501810cac346ef5eb81c8c09b36a75d70fa068",
        "partition_load": "e940591748286c821f880e09339ffe21b79d9a5a7a2541de961189aca36d0c27",
        "kafka_cluster_state": "504ad24a93087bd611e0796ef49aa3fdd9ed794ce248ed6cd9f4386501b62a8c",
        "proposals": "a718da38913a116197c23fc5ad81a39b27b8d80c1c9a97603e6b96153a9235f2",
        "proposals again": "a718da38913a116197c23fc5ad81a39b27b8d80c1c9a97603e6b96153a9235f2",
        "rebalance": "639dbce65b40c60858f856d6c219ee2ab8114486de82441bf496dbd588a664ac",
        "demote": "77335a0a6f126a74352f98c490541f9f6730feb833bcb955efd5ebd95fd51bfb",
        "user_tasks": "0d4e69b42e4841d81d0db05e293010d20586b0cf08acc97a23a3338b222fd33f"
    },
    "sections": {
        "proposals": {
            "summary": "7409a0f7c95e679c9fb154c976775413cb7e0ca3c9314b161948c3ff05ffd898",
            "goalSummary": "018644c967fa1003699b7d232d0b913b89af6ad2145ac76287240ba93967bec6",
            "proposals": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
            "version": "6b86b273ff34fce19d6b804eff5a3f5747ada4eaa22f1d49c01e52ddb7875b4b"
        },
        "proposals again": {
            "summary": "7409a0f7c95e679c9fb154c976775413cb7e0ca3c9314b161948c3ff05ffd898",
            "goalSummary": "018644c967fa1003699b7d232d0b913b89af6ad2145ac76287240ba93967bec6",
            "proposals": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
            "version": "6b86b273ff34fce19d6b804eff5a3f5747ada4eaa22f1d49c01e52ddb7875b4b"
        },
        "rebalance": {
            "summary": "33f2ea45f17a93eaa20e26976aab4fe86d2e154e99548b7d27bd94ee6b1781d5",
            "goalSummary": "5e48c41402627acd77b08ccc529e45667822dd20e254d6c24bb53c5a30c452bb",
            "proposals": "c9e3c79025963211e59940dc1f25571ab674aa82ddbcbf041d77d0c8185bb3df",
            "version": "6b86b273ff34fce19d6b804eff5a3f5747ada4eaa22f1d49c01e52ddb7875b4b"
        },
        "demote": {
            "summary": "eb1f25b5c0b006a1f896e0dba463b7a8f1a1ad423cbb62e6fea0f52f5ce0b723",
            "goalSummary": "e2f66e1bd7ac9ca0bc83aee7ef148f076a27fb65ef1a13df9e4f7c91207424ba",
            "proposals": "9707c6ee26ed3e650b71266239f1ee2857d45bff841c214cc4fed41a4a7c1285",
            "version": "6b86b273ff34fce19d6b804eff5a3f5747ada4eaa22f1d49c01e52ddb7875b4b"
        }
    },
    "demoteFirst": [
        "progress"
    ],
    "solves": 3,
    "proposalsCached": True,
    "demoted": 1866,
    "executed": {
        "numTotalMovements": 11630,
        "numFinishedMovements": 11630,
        "numInProgressMovements": 0,
        "numAbortedOrDead": 0,
        "byState": {
            "PENDING": 0,
            "IN_PROGRESS": 0,
            "ABORTING": 0,
            "ABORTED": 0,
            "DEAD": 0,
            "COMPLETED": 11630
        },
        "stopped": False,
        "failedTasks": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "admitted": 11630,
        "numTrimmed": 0,
        "trimmedByReason": {},
        "aborted": False,
        "generationSkew": 0,
        "batchRevalidations": 14,
        "trimmed": "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "batches": 15,
        "dispatchSha256": "2566e462fa0fb1ba110ea70e1c6669ebe1db4d6200d703a0518c085cc9432144",
        "assignmentSha256": "abf2349475c698139b47cca11907b2d4d5d4366b266150e2b7d0611194037427"
    },
    "metricsSensors": [
        "AnomalyDetector.breaker-state",
        "AnomalyDetector.detection-timer",
        "DeviceTelemetry.device-memory",
        "DeviceTelemetry.device-to-host-bytes",
        "DeviceTelemetry.device-to-host-transfers",
        "DeviceTelemetry.host-to-device-bytes",
        "DeviceTelemetry.host-to-device-transfers",
        "DeviceTelemetry.overhead-seconds",
        "Executor.batch-dispatch-timer",
        "Executor.execution-timer",
        "Executor.generation-skew",
        "Executor.revalidation-timer",
        "Executor.task-completed",
        "GoalOptimizer.device-call-timer",
        "GoalOptimizer.device-dispatches",
        "GoalOptimizer.optimizer-round-timer",
        "GoalOptimizer.proposal-computation-timer",
        "GoalOptimizer.stack-execution-timer",
        "GoalOptimizer.static-ctx-cache-misses",
        "History.overhead-seconds",
        "History.points",
        "History.snapshots",
        "Incremental.goals-skipped",
        "Incremental.lane-armed",
        "LoadMonitor.cluster-model-creation-timer",
        "MoveLedger.build-timer",
        "MoveLedger.moves-recorded",
        "MoveLedger.runs-recorded",
        "MoveLedger.runs-retained",
        "Retry.TcpDriver.finished.failures",
        "Retry.TcpDriver.finished.recoveries",
        "Retry.TcpDriver.finished.retries",
        "SessionManager.active-sessions",
        "Tracer.overhead-seconds",
        "Tracer.ring-size",
        "Tracer.spans-recorded"
    ],
    "perfKeys": [
        "fingerprint",
        "history",
        "memory",
        "programs",
        "telemetryOverheadS",
        "timers",
        "transfers",
        "version"
    ],
    "perfFingerprintKeys": [
        "deviceCount",
        "deviceKind",
        "gitSha",
        "platform",
        "probeFallback"
    ]
}
JAX_CPU_DIGESTS["served proposals"] = (
    "e3b0c44298fc1c14",
    {},
    "85eea2e06ea42159987ea887ea84eaedb8adf9d5246f4c8c1c48fd5eb2e96492")
JAX_CPU_DIGESTS["served rebalance"] = (
    "c6d2555b680086b5",
    {"ReplicaDistributionGoal": 12674,
     "DiskUsageDistributionGoal": 3365,
     "TopicReplicaDistributionGoal": 7081,
     "LeaderBytesInDistributionGoal": 15377},
    "61fc675ab5d069f7ad51f42bcc7f8260a04dd0ff9c90b0f0e38bc040f6213c5c")
JAX_CPU_DIGESTS["served demote"] = (
    "34df3fc032ea2759",
    {"LeaderReplicaDistributionGoal": 13026},
    "abf2349475c698139b47cca11907b2d4d5d4366b266150e2b7d0611194037427")
JAX_CPU_SERVED_REFERENCE = {
    "served proposals": {
        "RackAwareGoal": (0, 0, 1, True, 0.0, 0.0),
        "ReplicaCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    },
    "served rebalance": {
        "RackAwareGoal": (0, 0, 1, True, 0.0, 0.0),
        "ReplicaCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
        "ReplicaDistributionGoal": (153, 0, 61, True, 13170.0, 0.0),
        "DiskUsageDistributionGoal": (583, 48, 64, False, 77.44, 43.56),
        "TopicReplicaDistributionGoal": (1430, 0, 41, True, 6387.0, 0.0),
        "LeaderBytesInDistributionGoal": (631, 87, 64, False, 5829000.0, 3073000.0),
    },
    "served demote": {
        "LeaderReplicaDistributionGoal": (703, 0, 46, True, 14850.0, 0.0),
    },
}
JAX_CPU_SERVED_MOVES = {
    "served proposals": {
        "replica": 0,
        "leadership": 0
    },
    "served rebalance": {
        "replica": 24071,
        "leadership": 5757
    },
    "served demote": {
        "replica": 10234,
        "leadership": 1396
    }
}
JAX_CPU_SERVED_K11_SHA256 = {
    "initial": "ecf3d379930542175e8dee7238654de4fb70e1696103db098cc8a1d19fbc5834",
    "final": "8d054843f040570b7608c01285f9cfff6b879c6bd28f7efdaa92d148aca8e8b8"
}
#: the kernels of each solve's path
HARD_PATH = ("segment_aggregates", "broker_topk", "score_candidates", "apply_wave",
             "window_sum", "state_fingerprint", "cluster_stats")
STACK_PATH = HARD_PATH + ("score_swaps", "pair_picks")
#: the bench's batched pass and the greedy pass on models without dead
#: brokers, where the swaps run only if a drain round stalls
BENCH_PATH = HARD_PATH + ("pair_picks",)
GREEDY_PATH = BENCH_PATH + ("grid_shortlist",)
#: the lane's proposals: a full-stack re-solve after K10's scatter
LANE_PATH = STACK_PATH + ("delta_scatter",)
#: the option phases' paths: every machine solve's kernels; the swaps (K5)
#: where the usage goals run with moves (self-healing, destinations,
#: kafka-assigner); K11 in the demote phase
_MACHINE_PATH = ("segment_aggregates", "broker_topk", "score_candidates", "apply_wave",
                 "state_fingerprint", "cluster_stats")
OPTION_PATH = {
    "self-healing": _MACHINE_PATH + ("window_sum", "score_swaps"),
    "decommission": _MACHINE_PATH + ("window_sum",),
    "demote": _MACHINE_PATH + ("elect_preferred",),
    "destinations": _MACHINE_PATH + ("window_sum", "score_swaps"),
    "kafka-assigner": _MACHINE_PATH + ("window_sum", "score_swaps"),
}
#: phase 20's decommission solve: the service's settings from the
#: configuration, its two hard goals through the chunked machine (no soft
#: goal runs, so neither the windows' sums nor the swaps and pair drains)
SELF_HEALING_PATH = _MACHINE_PATH
#: phase 23's greedy solve on the mesh: K9 once a shard and K12 once a grid round
MESH_PATH = GREEDY_PATH + ("shard_merge",)
#: the kernels of the JSON line, in the order of build.KERNEL_SOURCES
ALL_KERNELS = ("segment_aggregates", "broker_topk", "score_candidates", "apply_wave",
               "score_swaps", "pair_picks", "window_sum", "state_fingerprint", "cluster_stats",
               "grid_shortlist", "delta_scatter", "elect_preferred", "shard_merge",
               "partition_stats")
#: phase 23's meshes, shards of the one card: 4 for the parity model (40,316
#: = 4 x 10,079 partitions, so the mesh pads nothing), 8 for the smoke
#: model's bucketed service solve (212,992 = 8 x 26,624) and for the kernel
#: rows (the smoke model's 199,518 partitions padded to 199,520)
MESH_PARITY_SHARDS, MESH_SERVICE_SHARDS = 4, 8
#: phase 23's K12 record sets: (shards, records a shard), and their kinds
MESH_MERGE_SHAPES = ((2, 1), (4, 1), (8, 1), (2, 16), (4, 16), (8, 16))
MESH_MERGE_KINDS = ("random", "equal scores across shards", "-0.0 against +0.0",
                    "shards all -inf", "all -inf")
#: partitions the lane phase's first proposal adds (inside the bucket)
LANE_ADDS = 8
#: `_run_chunked`'s target wall time per machine call in every solve:
#: huge, so each call's budget is 8x the last (from `chunk_rounds`, up to
#: 4,096) whatever the clock says. Where the calls end can move decisions, in
#: the JAX package and the port alike (ROADMAP.md Queue 3), so both sides run
#: this one schedule
PINNED_TARGET_S = 1e9
#: the bench's config-5 parity model (bench.py:596-604: 520 brokers, seed
#: 42 + 5) and parity gate (bench.py:189-203, :546-580)
PARITY_BROKERS = 520
PARITY_COST_REL, PARITY_COST_FLOOR, PARITY_COUNT_SLACK = 0.05, 0.01, 3


#: entries of chip_smoke's two-leg relay wave for K4
K4_RELAY_ENTRIES = 2600
#: the cluster of K4's wide-configuration row (generators.ClusterProperty):
#: 5,000 brokers, bucketed to 5,120, so that the bulk planner's wave holds
#: more entries than K4's block configuration takes
WIDE_CLUSTER = dict(num_racks=50, num_brokers=5000, num_topics=1000,
                    mean_partitions_per_topic=20.0, replication_factor=3,
                    load_distribution="pareto", mean_utilization=0.5)


def k4_relay_wave(a_np: np.ndarray, num_brokers: int, n: int = K4_RELAY_ENTRIES):
    """K4's two-leg wave in the relay form (two promotions per entry, three
    brokers, two hosts and two partitions claimed), seeded on the assignment
    `a_np` with integer scores to force ties. As in every relay, leg 2
    promotes a partition led by leg 1's destination d. Returns CPU tensors
    (p, kind, slot, dst, p2, kind2, slot2, dst2, score, ok)."""
    rng = np.random.default_rng(SEED)
    p_count, r = a_np.shape
    led_by = np.argsort(a_np[:, 0], kind="stable")
    first = np.searchsorted(a_np[led_by, 0], np.arange(num_brokers + 1))
    lp1, ls1 = rng.integers(0, p_count, n), rng.integers(1, r, n)
    d_np = a_np[lp1, ls1]
    d0 = np.maximum(d_np, 0)
    n_led = first[d0 + 1] - first[d0]
    lp2 = led_by[np.minimum(first[d0] + (rng.random(n) * n_led).astype(np.int64), p_count - 1)]
    ls2 = rng.integers(1, r, n)
    e_np = a_np[lp2, ls2]
    ok_np = ((d_np >= 0) & (n_led > 0) & (a_np[lp2, 0] == d_np) & (e_np >= 0)
             & (a_np[lp1, 0] >= 0) & (a_np[lp1, 0] != d_np) & (lp1 != lp2)
             & (rng.random(n) < 0.9))
    lead = np.full(n, 1, dtype=np.int32)
    wave = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
            for x in (lp1, lead, ls1, d_np, lp2, lead, ls2, e_np)]
    return wave + [torch.from_numpy(rng.integers(0, 8, n).astype(np.float32)),
                   torch.from_numpy(ok_np)]


def k4_relay_apply(fn, st, agg, w):
    """Apply k4_relay_wave's wave `w` with `fn` (apply_wave or its plain version)."""
    return fn(st, agg, *w[:4], w[8], w[9], 7, leg2=tuple(w[4:8]), brokers3=True)


def k4_bulk_wave(model_cpu, device: str):
    """The bulk count planner's first wave (one leg, one entry per broker)
    for ReplicaDistributionGoal on the smoke model's bucketed service
    context, as `GoalOptimizer(settings=SERVICE_SETTINGS)` prepares it on
    `device`: the priors' tables of the goals before it, its drain
    contributions, the first round. Returns (static, agg, args): the context
    before the wave and apply_wave's arguments after the two context ones."""
    from cruise_control_torch.analyzer import bulk
    from cruise_control_torch.analyzer import optimizer as opt
    from cruise_control_torch.analyzer.acceptance import build_tables
    from cruise_control_torch.analyzer.context import compute_aggregates
    from cruise_control_torch.analyzer.goals import goals_by_priority

    settings = opt.SERVICE_SETTINGS
    _, pmodel, dims, static, _, _ = opt.GoalOptimizer(device=device,
                                                      settings=settings)._build_ctx(model_cpu)
    agg = compute_aggregates(static, pmodel.assignment, dims)
    goals = goals_by_priority(None)
    goal = next(g for g in goals if g.name == "ReplicaDistributionGoal")
    tables = build_tables(goals[:goals.index(goal)], static, agg, dims)
    gs = goal.prepare(static, agg, dims)
    round_fn = bulk.make_bulk_count_round(goal, dims, settings.drain_per_broker,
                                          settings.bulk_waves)
    recorded = []
    real = bulk.apply_wave

    def record(st, ag, *args):
        if not recorded:
            recorded.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(st, ag, *args)

    bulk.apply_wave = record
    try:
        round_fn(static, type(agg)(*(t.clone() for t in agg)), tables, gs,
                 goal.drain_contrib(static, gs, agg), 0)
    finally:
        bulk.apply_wave = real
    if not recorded:
        fail("K4 bulk wave: the bulk planner made no wave on the bucketed smoke model")
    return static, agg, recorded[0]


def lane_perturbations(fields: dict):
    """The lane phase's two fresh models, as numpy field dicts of the smoke
    model's fields (`FlatClusterModel._asdict()` as numpy arrays):
      (a) every partition of the lowest topic id with 20 to 48 partitions
          carries 4x its load, and LANE_ADDS new partitions of that topic,
          each with the load of one of its spiked partitions, sit on three
          distinct alive brokers drawn from a seeded generator;
      (b) (a) with one more dead broker: the alive broker holding the most
          replicas (the lowest id among equals)."""
    a, pl, tid, state = (fields[k] for k in ("assignment", "part_load", "topic_id",
                                             "broker_state"))
    counts = np.bincount(tid)
    topic = int(np.nonzero((counts >= 20) & (counts <= 48))[0][0])
    rows = np.nonzero(tid == topic)[0]
    spiked = pl.copy()
    spiked[rows] *= np.float32(4.0)
    rng = np.random.default_rng(SEED)
    alive = np.nonzero(state != 3)[0]
    new_a = np.stack([rng.choice(alive, size=a.shape[1], replace=False)
                      for _ in range(LANE_ADDS)]).astype(a.dtype)
    new_load = spiked[rows[np.arange(LANE_ADDS) % len(rows)]]
    model_a = dict(fields, assignment=np.concatenate([a, new_a]),
                   part_load=np.concatenate([spiked, new_load]),
                   topic_id=np.concatenate([tid, np.full(LANE_ADDS, topic, tid.dtype)]))
    per_broker = np.bincount(a[a >= 0], minlength=state.shape[0])
    victim = int(np.argmax(np.where(state == 0, per_broker, -1)))
    state_b = state.copy()
    state_b[victim] = 3
    return model_a, dict(model_a, broker_state=state_b)


#: the kafka-assigner request of the option phases
KAFKA_ASSIGNER_NAMES = ("KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal")
#: the self-healing phase's goal.violation.distribution.threshold.multiplier
SELF_HEALING_MULTIPLIER = 2.5
#: the decommission phase's excluded topics: topic-100 .. topic-199
DECOMMISSION_TOPIC_PATTERN = r"topic-1\d\d"


def option_recipes(fields: dict):
    """The option phases' recipes on the smoke model, each a JAX facade flow:
    {label: (model fields, goal names or None, OptimizationOptions keyword
    arguments, threshold multiplier)}. `fields` are the smoke model's numpy
    fields. The broker groups are every 100th alive broker from four
    offsets (26 brokers each):
      self-healing  rebalance(options=is_triggered_by_goal_violation), the
                    constraint's multiplier at SELF_HEALING_MULTIPLIER;
      decommission  the offset-0 group marked DEAD, only_move_immigrants, the
                    topics matching DECOMMISSION_TOPIC_PATTERN excluded;
      demote        the offset-50 group marked DEMOTED and excluded from
                    leadership, LeaderReplicaDistributionGoal alone;
      destinations  the offset-25 group marked NEW and named as the only
                    destinations, the offset-10 group excluded from replica
                    moves;
      kafka-assigner the two kafka-assigner goals, default options.
    The masks are numpy bool arrays; the symbolic fields (the topic pattern,
    the destination ids) are resolved by `resolve_options`."""
    state = fields["broker_state"]
    alive = np.nonzero(state != 3)[0]
    group = {k: alive[k::100][:26] for k in (0, 10, 25, 50)}

    def mask(ids):
        m = np.zeros(state.shape[0], dtype=bool)
        m[ids] = True
        return m

    def with_state(ids, value):
        s = state.copy()
        s[ids] = value
        return dict(fields, broker_state=s)

    return {
        "self-healing": (fields, None, dict(is_triggered_by_goal_violation=True),
                         SELF_HEALING_MULTIPLIER),
        "decommission": (with_state(group[0], 3), None,
                         dict(only_move_immigrants=True,
                              excluded_topic_pattern=DECOMMISSION_TOPIC_PATTERN), 1.0),
        "demote": (with_state(group[50], 2), ("LeaderReplicaDistributionGoal",),
                   dict(excluded_brokers_for_leadership=mask(group[50])), 1.0),
        "destinations": (with_state(group[25], 1), None,
                         dict(destination_broker_ids=tuple(int(b) for b in group[25]),
                              excluded_brokers_for_replica_move=mask(group[10])), 1.0),
        "kafka-assigner": (fields, KAFKA_ASSIGNER_NAMES, {}, 1.0),
    }


#: windows the monitored phase publishes and samples
MONITOR_WINDOWS = 2


def monitored_model(model, ns):
    """Phase 18's front half, the load monitor's path: a SimulatedCluster of
    `model` publishes every alive broker's metrics into an InMemoryTransport
    once a window, and a LoadMonitor (a MetadataClient on the simulator's
    topology, a TransportMetricSampler, LoadMonitorConfig()'s windows, a
    scripted clock) samples once a window, as tests/test_monitor.py's `pump`
    does, for MONITOR_WINDOWS windows; then `cluster_model` under the
    facade's default requirements (one window, half of the partitions).
    `ns` names the package's SimulatedCluster, InMemoryTransport,
    MetadataClient, TransportMetricSampler, LoadMonitor, LoadMonitorConfig and
    ModelCompletenessRequirements, so that the JAX package's monitor runs the
    same recipe for the references. Returns (model, metadata, host seconds
    of emission, sampling and model build, samples ingested, the simulator,
    the monitor): phase 19 executes on that simulator under that monitor."""
    sim = ns.SimulatedCluster(model)
    transport = ns.InMemoryTransport()
    config = ns.LoadMonitorConfig()
    clock = {"now": 0.0}
    monitor = ns.LoadMonitor(ns.MetadataClient(sim.fetch_topology, ttl_s=0.0),
                             ns.TransportMetricSampler(transport), config=config,
                             clock=lambda: clock["now"])
    monitor.start_up()
    seconds = {"emit": 0.0, "sample": 0.0, "build": 0.0}
    ingested = 0
    w = config.window_ms
    for r in range(MONITOR_WINDOWS):
        t_ms = r * w + w // 2
        t0 = time.perf_counter()
        transport.publish(sim.all_metrics(t_ms))
        seconds["emit"] += time.perf_counter() - t0
        clock["now"] = (t_ms + w // 4) / 1000.0
        t0 = time.perf_counter()
        ingested += monitor.sample_once()
        seconds["sample"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    out, meta = monitor.cluster_model(ns.ModelCompletenessRequirements(
        min_required_num_windows=1, min_monitored_partitions_percentage=0.5))
    seconds["build"] = time.perf_counter() - t0
    return out, meta, seconds, ingested, sim, monitor


#: phase 19's executor: ExecutorConfig.from_config of the default
#: configuration but for the poll interval. The configuration's default,
#: execution.progress.check.interval.ms = 10,000, paces a real cluster's
#: movements; a simulated movement completes after a count of polls, not of
#: seconds, so the dispatch order is the same at 10 ms, ExecutorConfig()'s
#: own default and what the JAX service runs on a simulated cluster when it
#: is started without a properties file (main.py)
EXECUTION_CONFIG = {"execution.progress.check.interval.ms": 10}
#: polls a simulated movement takes (the JAX service's SimulatorClusterDriver)
LATENCY_POLLS = 2
#: the chaos run's perturbation: at this driver poll, the broker that
#: receives the most added replicas dies
CHAOS_KILL_POLL = 2


def stamp(result, monitor, metadata, ns):
    """The JAX facade's stamping of a monitored solve (facade.py:133-141 and
    :158-167): each proposal named by its topic-partition, and the result
    stamped with the monitor's generation and the fingerprint of a metadata
    refresh. `ns` names the package's TopologyFingerprint."""
    result.proposals = [dataclasses.replace(p, topic_partition=metadata.topic_partition(
        p.partition)) for p in result.proposals]
    result.generation = monitor.generation
    result.fingerprint = ns.TopologyFingerprint.from_topology(monitor._metadata.refresh_metadata())
    return result


def executor_config(ns):
    return ns.ExecutorConfig.from_config(ns.CruiseControlConfig(EXECUTION_CONFIG))


def execute_monitored(result, sim, monitor, ns):
    """Phase 19 (a): a stamped result through the package's Executor on a
    SimulatorClusterDriver of `sim` (LATENCY_POLLS polls a movement), under
    `monitor`. The driver records the partitions of each dispatch batch, in
    order (the executor polls between two batches), and whether the
    monitor's sampling was paused at each dispatch. Returns (the execution
    summary, the batches, those flags, host seconds)."""
    paused = []

    class RecordingDriver(ns.SimulatorClusterDriver):
        def __init__(self):
            super().__init__(sim, latency_polls=LATENCY_POLLS)
            self.batches = []
            self._open = None

        def poll(self):
            self._open = None
            super().poll()

        def _record(self, kind, task):
            paused.append(monitor.sampling_paused)
            if self._open != kind:
                self.batches.append([kind, []])
                self._open = kind
            self.batches[-1][1].append(int(task.proposal.partition))

        def start_replica_movement(self, task):
            self._record("replica", task)
            super().start_replica_movement(task)

        def start_leadership_movement(self, task):
            self._record("leadership", task)
            super().start_leadership_movement(task)

    driver = RecordingDriver()
    executor = ns.Executor(driver, executor_config(ns), load_monitor=monitor)
    t0 = time.perf_counter()
    summary = executor.execute_proposals(
        result.proposals, generation=result.generation, fingerprint=result.fingerprint,
        provenance_run=result.provenance.run_id if result.provenance is not None else None)
    return summary, driver.batches, paused, time.perf_counter() - t0


def chaos_run(model, result, ns):
    """Phase 19 (b): a ChaosHarness on a fresh SimulatedCluster of `model`
    with the executor of `executor_config`, the stamped result's proposals
    and a ChaosPlan that kills, at poll CHAOS_KILL_POLL, the broker that
    receives the most added replicas (the lowest index of a tie). Returns
    (that broker, the execution summary, the harness, host seconds)."""
    adds = {}
    for p in result.proposals:
        for b in p.replicas_to_add:
            adds[b] = adds.get(b, 0) + 1
    victim = int(min(adds, key=lambda b: (-adds[b], b)))
    plan = ns.ChaosPlan([ns.Perturbation(at_poll=CHAOS_KILL_POLL, action="kill_broker",
                                         broker=victim)])
    t0 = time.perf_counter()
    harness = ns.ChaosHarness(ns.SimulatedCluster(model), plan, latency_polls=LATENCY_POLLS,
                              config=executor_config(ns))
    summary = harness.execute((result.proposals, result.generation, result.fingerprint))
    return victim, summary, harness, time.perf_counter() - t0


def digest_json(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def execution_record(summary, assignment, batches=None) -> dict:
    """What phase 19 holds to the JAX run: an execution summary without its
    ids, times and run ids (the per-state counts, the failed tasks' types,
    states and reasons, the proposal validation's admissions and trims),
    the SHA-256 of the dispatch order (`batches`, when recorded) and of the
    simulator's assignment afterwards."""
    v = summary["proposalValidation"]
    out = {k: summary[k] for k in ("numTotalMovements", "numFinishedMovements",
                                   "numInProgressMovements", "numAbortedOrDead", "byState",
                                   "stopped")}
    out["failedTasks"] = digest_json([[e["type"], e["state"], e["reason"]]
                                      for e in summary["failedTasks"]])
    out.update({k: v[k] for k in ("admitted", "numTrimmed", "trimmedByReason", "aborted",
                                  "generationSkew", "batchRevalidations")})
    out["trimmed"] = digest_json([[t["partition"], t["topicPartition"], t["reason"], t["phase"]]
                                  for t in v["trimmed"]])
    if batches is not None:
        out["batches"] = len(batches)
        out["dispatchSha256"] = digest_json(batches)
    out["assignmentSha256"] = hashlib.sha256(
        np.ascontiguousarray(assignment, dtype=np.int32).tobytes()).hexdigest()
    return out


#: phase 20's detector clock (s): the sweep runs at this time, the handler the
#: configuration's self-healing threshold later, when the ladder fixes at once
SELF_HEALING_T0_S = 7200.0
#: phase 20's configuration: phase 19's, with `default.goals` (the goals the
#: facade runs when a request names none, as a broker failure's fix does)
#: trimmed to the hard goals the smoke model can satisfy, which a broker's
#: evacuation needs. Its capacity goals cannot be: 24 alive brokers hold a
#: partition larger than their disk capacity (up to 3.17 times), so with
#: them the decommission raises OptimizationFailureException in both
#: packages and nothing executes. The soft goals, unconverged on this
#: cluster, would go on rebalancing it through the fake agent, whose apply
#: costs O(brokers) a movement.
SELF_HEALING_CONFIG = dict(EXECUTION_CONFIG,
                           **{"default.goals": "RackAwareGoal,ReplicaCapacityGoal"})


#: the classes phase 20 builds its service from, by the module of the package
#: that holds each (`package_classes`)
SELF_HEALING_CLASSES = {
    "CruiseControlConfig": "config", "BalancingConstraint": "config.balancing",
    "GoalOptimizer": "analyzer.optimizer", "OptimizerSettings": "analyzer.optimizer",
    "IncrementalConfig": "analyzer.incremental", "FakeClusterAgent": "testing.fake_agent",
    "TcpClusterDriver": "executor", "RetryPolicy": "common.retry", "Executor": "executor",
    "ExecutorConfig": "executor", "CruiseControl": "facade", "FacadeConfig": "facade",
    "ModelCompletenessRequirements": "monitor.completeness",
    "SelfHealingNotifier": "detector", "AnomalyDetector": "detector"}


def package_classes(package: str, table: dict):
    """A namespace of the classes `table` names ({class: module}) from
    `package` (cruise_control_torch here; the references' scripts and tests
    pass the JAX package's name)."""
    import importlib
    from types import SimpleNamespace

    return SimpleNamespace(**{name: getattr(importlib.import_module(f"{package}.{module}"), name)
                              for name, module in table.items()})


def named_agent(ns):
    """The package's FakeClusterAgent class, addressing a reassignment or
    election by its topic's name and its partition's index in the topic, as
    a Kafka controller does. The fake agent itself reads `partition` as the
    simulator's dense row, which only an unnamed proposal sends; the
    facade names every proposal (fault F5, ROADMAP.md Queue 3)."""

    class NamedAgent(ns.FakeClusterAgent):
        def __init__(self, sim, **kwargs):
            super().__init__(sim, **kwargs)
            topo = sim.fetch_topology()
            self._rows = {(topo.topic_names[t], int(k)): p
                          for p, (t, k) in enumerate(zip(topo.topic_id, topo.partition_index))}

        def _dispatch(self, req):
            row = self._rows.get((req.get("topic"), req.get("partition")))
            if row is not None and req.get("op") in ("reassign", "leader"):
                req = dict(req, partition=row)
            return super()._dispatch(req)

    return NamedAgent


def recording_tcp_driver(ns):
    """The package's TcpClusterDriver class, recording the partitions of each
    dispatch batch in order (the executor polls between two batches), as
    execute_monitored's driver does."""

    class RecordingTcpDriver(ns.TcpClusterDriver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.batches = []
            self._open = None

        def poll(self):
            self._open = None
            super().poll()

        def _record(self, kind, task):
            if self._open != kind:
                self.batches.append([kind, []])
                self._open = kind
            self.batches[-1][1].append(int(task.proposal.partition))

        def start_replica_movement(self, task):
            self._record("replica", task)
            super().start_replica_movement(task)

        def start_leadership_movement(self, task):
            self._record("leadership", task)
            super().start_leadership_movement(task)

    return RecordingTcpDriver


def self_healing(sim, monitor, ns, **optimizer_kw):
    """Phase 20 on phase 19 (a)'s simulator and monitor, the self-healing
    loop as the JAX package's main.py builds the service from a
    configuration (SELF_HEALING_CONFIG): a GoalOptimizer of
    BalancingConstraint.from_config and OptimizerSettings.from_config (the
    pinned schedule), a CruiseControl facade (the service's requirements,
    the configuration's `default.goals`, IncrementalConfig.from_config), an
    Executor (ExecutorConfig.from_config) on a TcpClusterDriver
    (RetryPolicy.from_config) to a FakeClusterAgent of `sim` on loopback
    (named_agent, LATENCY_POLLS polls a movement), and an AnomalyDetector with
    a SelfHealingNotifier of the configuration's thresholds, broker-failure
    self-healing on. The alive broker that holds the most replicas (the
    lowest index of a tie) is killed; the detector sweeps at
    SELF_HEALING_T0_S and handles the anomaly the self-healing threshold
    later: BrokerFailures.fix decommissions the broker through the facade
    (`decommission_brokers(dryrun=False)`), which solves and executes over
    the wire. `ns` names the package's classes; `optimizer_kw` goes to the
    GoalOptimizer (the port's device). Returns the victim, what the detector
    found and decided, its state, the facade's decommission model, result
    and execution summary, the dispatch batches and the host seconds of
    detection, model build, solve, stamping and execution."""
    cfg = ns.CruiseControlConfig(SELF_HEALING_CONFIG)
    optimizer = ns.GoalOptimizer(
        constraint=ns.BalancingConstraint.from_config(cfg),
        settings=dataclasses.replace(ns.OptimizerSettings.from_config(cfg),
                                     chunk_target_s=PINNED_TARGET_S), **optimizer_kw)
    agent = named_agent(ns)(sim, latency_polls=LATENCY_POLLS).start()
    driver = recording_tcp_driver(ns)(*agent.address,
                                      retry_policy=ns.RetryPolicy.from_config(cfg))
    try:
        executor = ns.Executor(driver, ns.ExecutorConfig.from_config(cfg), load_monitor=monitor)
        facade = ns.CruiseControl(monitor, executor, optimizer=optimizer, config=ns.FacadeConfig(
            default_requirements=ns.ModelCompletenessRequirements(1, 0.5, False),
            default_goal_names=tuple(cfg.goal_names("default.goals")),
            incremental=ns.IncrementalConfig.from_config(cfg)))
        notifier = ns.SelfHealingNotifier(
            self_healing_broker_failure_enabled=True,
            broker_failure_alert_threshold_s=cfg.get_long(
                "broker.failure.alert.threshold.ms") / 1000.0,
            self_healing_threshold_s=cfg.get_long(
                "broker.failure.self.healing.threshold.ms") / 1000.0,
            breaker_threshold=cfg.get_int("selfhealing.breaker.threshold"),
            breaker_cooldown_s=cfg.get_double("selfhealing.breaker.cooldown.s"))
        topo = sim.fetch_topology()
        a = np.asarray(topo.assignment)
        held = np.bincount(a[a >= 0], minlength=topo.num_brokers)
        victim = int(np.argmax(np.where(np.asarray(topo.broker_state) != 3, held, -1)))
        sim.kill_broker(victim)
        clock = {"now": SELF_HEALING_T0_S}
        detector = ns.AnomalyDetector(facade, notifier=notifier, clock=lambda: clock["now"])
        seconds = {}
        t0 = time.perf_counter()
        queued = detector.detect_once()
        seconds["detection"] = time.perf_counter() - t0
        detected = detector.state()["recentAnomalies"]
        clock["now"] += notifier.self_healing_threshold_s
        # the fix's steps, timed where the facade calls them
        out = {}
        build, solve = monitor.cluster_model, optimizer.optimizations
        execute = executor.execute_proposals

        def timed_build(*args, **kwargs):
            t = time.perf_counter()
            built = build(*args, **kwargs)
            seconds["model build"] = time.perf_counter() - t
            return built

        def timed_solve(model, **kwargs):
            t = time.perf_counter()
            out["result"], out["model"] = solve(model, **kwargs), model
            out["solved_at"] = time.perf_counter()
            seconds["solve"] = out["solved_at"] - t
            return out["result"]

        def timed_execute(*args, **kwargs):
            t = time.perf_counter()
            seconds["stamping"] = t - out["solved_at"]
            out["summary"] = execute(*args, **kwargs)
            seconds["execution"] = time.perf_counter() - t
            return out["summary"]

        monitor.cluster_model, optimizer.optimizations = timed_build, timed_solve
        executor.execute_proposals = timed_execute
        try:
            action = detector.handle_once()
        finally:
            del monitor.cluster_model, optimizer.optimizations, executor.execute_proposals
    finally:
        driver.close()
        agent.stop()
    state = detector.state()
    return dict(victim=victim, queued=queued, detected=detected, action=action,
                fixes=state["fixesTriggered"], fix_failures=state["fixFailures"],
                model=out.get("model"), result=out.get("result"), summary=out.get("summary"),
                batches=driver.batches, seconds=seconds)


def self_healing_record(out, sim) -> dict:
    """What phase 20 holds to the JAX run: the victim, the detector's
    anomalies, decision and fix counts, the solve's moves, and the
    execution's record (execution_record, the dispatch order included)."""
    res = out["result"]
    return dict(
        victim=out["victim"], queued=out["queued"], detected=out["detected"],
        action=out["action"], fixesTriggered=out["fixes"], fixFailures=out["fix_failures"],
        moves={"replica": res.num_replica_moves, "leadership": res.num_leadership_moves},
        executed=execution_record(out["summary"], np.asarray(sim.fetch_topology().assignment),
                                  out["batches"]))


#: the classes phase 21 builds its service from: phase 20's, the async
#: operations, the REST app and the client
SERVED_CLASSES = dict(SELF_HEALING_CLASSES, AsyncCruiseControl="async_ops",
                      CruiseControlApp="servlet.server", CruiseControlClient="client.cccli")
#: phase 21's rebalance: the two hard goals the smoke model can satisfy and
#: soft goals whose solve runs window_sum's sums, the usage goal's replica
#: swaps and the leader goal's relays (K5) and the topic goal's pair drain
#: (K6); the capacity goals are left out (they cannot be satisfied,
#: SELF_HEALING_CONFIG)
SERVED_GOALS = ("RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal",
                "DiskUsageDistributionGoal", "TopicReplicaDistributionGoal",
                "LeaderBytesInDistributionGoal")
#: keys phase 21 takes out of a body before it is compared: task ids, clock
#: readings and durations, run ids, and the process-wide sensor snapshots
#: (their counts and times depend on everything the process ran before)
SERVED_VOLATILE = frozenset({"UserTaskId", "StartMs", "SubmitTimeMs", "startMs", "endMs",
                             "durationS", "provenanceRun", "Sensors", "sensors", "overheadS"})
#: /metrics sensors whose existence depends on what the process built or
#: compiled before (XLA programs in the JAX package, kernel libraries in the
#: port), left out of phase 21's comparison of the sensor names
SERVED_PROCESS_SENSORS = ("GoalOptimizer.program-cache-", "GoalOptimizer.stack-compile-timer",
                          "DeviceTelemetry.program-cost.")


def served_normalized(body):
    """`body` without the SERVED_VOLATILE keys, at any depth."""
    if isinstance(body, dict):
        return {k: served_normalized(v) for k, v in body.items() if k not in SERVED_VOLATILE}
    if isinstance(body, (list, tuple)):
        return [served_normalized(v) for v in body]
    return body


def metric_sensors(text: str) -> list:
    """The sensor names a /metrics page lists, less SERVED_PROCESS_SENSORS."""
    import re

    names = set(re.findall(r'sensor="([^"]+)"', text))
    return sorted(n for n in names if not n.startswith(SERVED_PROCESS_SENSORS))


def served(sim, monitor, ns, serve, around=None, **optimizer_kw):
    """Phase 21 on phase 20's simulator and monitor: the service built from
    SELF_HEALING_CONFIG as main.py builds it from a configuration (the
    optimizer of phase 20, a CruiseControl facade, AsyncCruiseControl, an
    AnomalyDetector, an Executor on a fresh TcpClusterDriver to named_agent),
    wrapped in the package's CruiseControlApp, served on loopback by
    `serve(app)` -> (url, stop), and driven by the package's
    CruiseControlClient: GET state, load, partition_load,
    kafka_cluster_state, proposals twice (the second a cache hit), POST
    rebalance (dry run, SERVED_GOALS, the hard-goal check skipped), POST
    demote_broker of the alive broker leading the most partitions (lowest
    index of a tie) with dryrun=false, answered 202 and then attached to by
    the client's session until 200 (its leadership moves execute over the
    wire), GET user_tasks, then /metrics and /perf, which the client cannot
    fetch (it sends what it does not know as a POST), with urllib.
    `around(label, call)` runs each request (the port's chip run counts the
    kernels' launches there). Returns the bodies, the demote's first answer,
    the solves' (model, result) in order, the execution summaries and the
    dispatch batches, the demoted broker and each request's host seconds."""
    import urllib.request

    cfg = ns.CruiseControlConfig(SELF_HEALING_CONFIG)
    optimizer = ns.GoalOptimizer(
        constraint=ns.BalancingConstraint.from_config(cfg),
        settings=dataclasses.replace(ns.OptimizerSettings.from_config(cfg),
                                     chunk_target_s=PINNED_TARGET_S), **optimizer_kw)
    agent = named_agent(ns)(sim, latency_polls=LATENCY_POLLS).start()
    driver = recording_tcp_driver(ns)(*agent.address,
                                      retry_policy=ns.RetryPolicy.from_config(cfg))
    executor = ns.Executor(driver, ns.ExecutorConfig.from_config(cfg), load_monitor=monitor)
    facade = ns.CruiseControl(monitor, executor, optimizer=optimizer, config=ns.FacadeConfig(
        default_requirements=ns.ModelCompletenessRequirements(1, 0.5, False),
        default_goal_names=tuple(cfg.goal_names("default.goals")),
        incremental=ns.IncrementalConfig.from_config(cfg)))
    acc = ns.AsyncCruiseControl(facade)
    detector = ns.AnomalyDetector(facade, notifier=ns.SelfHealingNotifier(
        breaker_threshold=cfg.get_int("selfhealing.breaker.threshold"),
        breaker_cooldown_s=cfg.get_double("selfhealing.breaker.cooldown.s")),
        clock=lambda: SELF_HEALING_T0_S)
    app = ns.CruiseControlApp(acc, anomaly_detector=detector)
    out = {"solves": [], "executions": [], "bodies": {}, "seconds": {}}
    solve, execute = optimizer.optimizations, executor.execute_proposals

    def recorded_solve(model, *args, **kwargs):
        result = solve(model, *args, **kwargs)
        out["solves"].append((model, result))
        return result

    def recorded_execute(*args, **kwargs):
        summary = execute(*args, **kwargs)
        out["executions"].append(summary)
        return summary

    optimizer.optimizations, executor.execute_proposals = recorded_solve, recorded_execute
    topo = sim.fetch_topology()
    leaders = np.bincount(np.asarray(topo.assignment)[:, 0], minlength=topo.num_brokers)
    demoted = int(np.argmax(np.where(np.asarray(topo.broker_state) != 3, leaders, -1)))
    url, stop = serve(app)
    client = ns.CruiseControlClient(url, poll_interval_s=0.05, timeout_s=3600)

    def get(path):
        with urllib.request.urlopen(url + path, timeout=600) as resp:
            return resp.read().decode()

    demote = {"brokerid": str(demoted), "dryrun": "false"}

    def demote_call():
        out["demote_first"] = client.request("demote_broker", demote, wait=False)
        if "progress" not in out["demote_first"]:
            return out["demote_first"]
        return client.request("demote_broker", demote)

    requests = [
        ("state", lambda: client.request("state")),
        ("load", lambda: client.request("load")),
        ("partition_load", lambda: client.request("partition_load")),
        ("kafka_cluster_state", lambda: client.request("kafka_cluster_state")),
        ("proposals", lambda: client.request("proposals")),
        ("proposals again", lambda: client.request("proposals")),
        ("rebalance", lambda: client.request("rebalance", {
            "dryrun": "true", "skip_hard_goal_check": "true", "goals": ",".join(SERVED_GOALS)})),
        ("demote", demote_call),
        ("user_tasks", lambda: client.request("user_tasks")),
        ("metrics", lambda: get("/kafkacruisecontrol/metrics")),
        ("perf", lambda: json.loads(get("/kafkacruisecontrol/perf"))),
    ]
    around = around or (lambda label, call: call())
    try:
        for label, call in requests:
            t0 = time.perf_counter()
            out["bodies"][label] = around(label, call)
            out["seconds"][label] = time.perf_counter() - t0
    finally:
        stop()
        acc.shutdown()
        driver.close()
        agent.stop()
        del optimizer.optimizations, executor.execute_proposals
    out.update(demoted=demoted, batches=driver.batches)
    return out


def served_record(out, sim) -> dict:
    """What phase 21 holds to the JAX run: each body's SHA-256 without the
    SERVED_VOLATILE keys (an optimization result's also section by section),
    how the demote first answered, the number of solves (the second
    proposals request is the cache's), the demoted broker, the demote's
    execution (execution_record), /metrics' sensor names (metric_sensors)
    and /perf's keys."""
    bodies = out["bodies"]
    rec = {"bodies": {}, "sections": {}}
    for label, body in bodies.items():
        if label in ("metrics", "perf"):
            continue
        norm = served_normalized(body)
        rec["bodies"][label] = digest_json(norm)
        if isinstance(norm, dict) and "goalSummary" in norm:
            rec["sections"][label] = {k: digest_json(v) for k, v in norm.items()}
    perf = bodies["perf"]
    rec.update(
        demoteFirst=sorted(out["demote_first"]), solves=len(out["solves"]),
        proposalsCached=bodies["proposals"] == bodies["proposals again"],
        demoted=out["demoted"],
        executed=execution_record(out["executions"][0],
                                  np.asarray(sim.fetch_topology().assignment), out["batches"])
        if out["executions"] else None,
        metricsSensors=metric_sensors(bodies["metrics"]),
        perfKeys=sorted(perf), perfFingerprintKeys=sorted(set(perf["fingerprint"]) - {
            "jax", "jaxlib", "torch", "cuda"}))
    return rec


#: the JAX facade's solves behind phase 21's requests, in order
SERVED_SOLVES = ("served proposals", "served rebalance", "served demote")
#: each of phase 21's requests that runs on the card, with the kernels its
#: path must launch: /load's broker loads (K1), the default goals' proposals
#: (the two hard goals through the machine), the rebalance's soft goals (the
#: windows' sums, the swaps and relays, the pair drain) and the demote's
#: LeaderReplicaDistributionGoal
SERVED_PATHS = {"proposals": SELF_HEALING_PATH,
                "rebalance": _MACHINE_PATH + ("window_sum", "score_swaps", "pair_picks"),
                "demote": _MACHINE_PATH, "load": ("segment_aggregates",)}
#: seconds phase 22's service has to exit after SIGINT
MAIN_SIGINT_S = 30
#: seconds phase 22 waits for the service to listen and for its monitor's
#: first window (the typed 503 before it)
MAIN_DEADLINE_S = 240


def served_phase(sim, monitor, name: str, card: str, run_and_check, device="cuda") -> dict:
    """Phase 21 on phase 20's simulator and monitor (served) with the port's
    classes on `device`: each request's kernel launches counted around it,
    each solve checked by `run_and_check` against its JAX digest, K11 on the
    demote's assignments, every record against JAX_CPU_SERVED, /perf against
    the card `name`. Returns the host seconds, the record and the launches;
    any failed check exits (the bodies go to chiprun_out/ when that
    directory exists)."""
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer.context import build_static_ctx, dims_of
    from cruise_control_torch.analyzer.goals import elect_preferred_leaders
    from cruise_control_torch.config import CruiseControlConfig
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.kernels.elect_preferred import elect_preferred_plain
    from cruise_control_torch.servlet.server import serve as serve_http

    def serve_port(app):
        handle = serve_http(app, "127.0.0.1", 0)
        return handle.url, handle.shutdown

    request_launches = {}

    def counted(label, call):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t_req = time.monotonic()
        body = call()
        torch.cuda.synchronize()
        request_launches[label] = (kernels.launches(), time.monotonic() - t_req)
        return body

    srv = served(sim, monitor, package_classes("cruise_control_torch", SERVED_CLASSES),
                 serve_port, around=counted, device=device)
    rec = served_record(srv, sim)
    if len(srv["solves"]) != 3:
        fail(f"served: {len(srv['solves'])} solves, expected 3 (proposals, rebalance, demote; "
             "the second proposals request answered from the cache)")
    for (model_s, res_s), label, request in zip(srv["solves"], SERVED_SOLVES,
                                                ("proposals", "rebalance", "demote")):
        run_and_check(label, model_s, lambda r=res_s: r, SERVED_PATHS[request],
                      JAX_CPU_SERVED_REFERENCE[label], JAX_CPU_SERVED_MOVES[label],
                      measured=request_launches[request])
    for request, path in SERVED_PATHS.items():
        counts = request_launches[request][0]
        if any(counts[k] == 0 for k in path):
            fail(f"served: {request} never launched {[k for k in path if counts[k] == 0]}")
    print(f"served: each request's launches "
          f"{json.dumps({k: v[0] for k, v in request_launches.items()})}")
    # K11 on the demote's initial and final assignments against its plain
    # version and JAX's election: a check beside the request, whose path (the
    # facade's demote, in both packages) runs no preferred-leader election
    model_d, res_d = srv["solves"][2]
    constraint = BalancingConstraint.from_config(CruiseControlConfig(SELF_HEALING_CONFIG))
    st_d = build_static_ctx(model_d.to(device), constraint, dims_of(model_d))
    st_dc = build_static_ctx(model_d, constraint, dims_of(model_d))
    for which, a_ in (("initial", model_d.assignment),
                      ("final", torch.from_numpy(res_d.final_assignment))):
        out = elect_preferred_leaders(st_d, a_.to(device)).cpu()
        if not bits_equal(out, elect_preferred_plain(a_, st_dc.demoted, st_dc.dead)):
            fail(f"served: K11 on the demote's {which} assignment differs from its plain version")
        sha = hashlib.sha256(np.ascontiguousarray(out.numpy(), dtype=np.int32)
                             .tobytes()).hexdigest()
        if sha != JAX_CPU_SERVED_K11_SHA256[which]:
            fail(f"served: K11 on the demote's {which} assignment differs from JAX's election")
    print("served: K11 on the demote's initial and final assignments equals its plain version "
          "and JAX's elect_preferred_leaders")
    print(f"served: {json.dumps(rec)}")
    mismatched = [k for k, want in JAX_CPU_SERVED.items() if k != "metricsSensors" and
                  rec[k] != want]
    missing = sorted(set(JAX_CPU_SERVED["metricsSensors"]) - set(rec["metricsSensors"]))
    if mismatched or missing:
        import pathlib

        dump = pathlib.Path("chiprun_out")
        if dump.is_dir():
            (dump / "chip_smoke_served.json").write_text(json.dumps(
                {k: served_normalized(v) for k, v in srv["bodies"].items() if k != "metrics"}))
        for k in mismatched:
            print(f"served: {k} {json.dumps(rec[k])} differs from the JAX run's "
                  f"{json.dumps(JAX_CPU_SERVED[k])}")
        fail(f"served: {mismatched} differ from the JAX run's; /metrics lacks {missing}")
    perf = srv["bodies"]["perf"]
    fp, mem = perf["fingerprint"], perf["memory"]
    if fp.get("platform") != "gpu" or fp.get("deviceKind") != name or \
            mem.get("peakBytesInUse", 0) <= 0 or mem.get("fallback") != 0:
        fail(f"served: /perf does not name the card or shows no device-memory peak: {fp}, {mem}")
    print("served: every body (less the volatile keys), the demote's first answer, the proposal "
          "cache's hit, the three solves and the demote's execution over the wire equal the JAX "
          f"run's; /perf names {fp['deviceKind']} with a "
          f"{mem['peakBytesInUse'] / 2**30:.2f} GiB device-memory peak")
    print("served: host seconds per request: " + ", ".join(
        f"{k} {v:.3f}" for k, v in srv["seconds"].items()) + f" ({card})")
    return dict(seconds=srv["seconds"], record=rec,
                launches={k: v[0] for k, v in request_launches.items()})


def entry_point_phase(name: str, card: str) -> dict:
    """Phase 22: `python -m cruise_control_torch.main --port <free>` as a
    subprocess (its default 12-broker simulated cluster, the solves on the
    card), driven by `python -m cruise_control_torch.client.cccli`: state,
    then proposals until the monitor has its first window (the typed 503
    before it, retried until MAIN_DEADLINE_S), kafka_cluster_state --verbose
    and rebalance --dryrun true. The background loops run on the wall clock,
    so the phase holds invariants: every command exits 0, the proposals
    replay from the cluster's assignment and leave no replica on a dead
    broker, /perf names the card `name` with a nonzero device-memory peak
    and the kernel libraries found in the build cache, /metrics counts at
    least one solve, and SIGINT stops the service within MAIN_SIGINT_S.
    Returns the host seconds of each step."""
    import os
    import signal
    import socket
    import tempfile
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    seconds = {}
    log = tempfile.TemporaryFile(mode="w+")
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "cruise_control_torch.main", "--port",
                             str(port)], stdout=log, stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))

    def output() -> str:
        log.seek(0)
        return log.read()[-4000:]

    def cli(*args):
        t = time.monotonic()
        out = subprocess.run([sys.executable, "-m", "cruise_control_torch.client.cccli", "-a",
                              url, "--json", *args], capture_output=True, text=True, timeout=600)
        seconds[args[0]] = time.monotonic() - t
        body = json.loads(out.stdout) if out.stdout.strip() else {}
        return out.returncode, body, out.stderr

    try:
        while True:
            if proc.poll() is not None:
                fail(f"main: the service exited with {proc.returncode} before it listened:\n"
                     f"{output()}")
            with socket.socket() as sock:
                if sock.connect_ex(("127.0.0.1", port)) == 0:
                    break
            if time.monotonic() - t0 > MAIN_DEADLINE_S:
                fail(f"main: the service did not listen within {MAIN_DEADLINE_S} s")
            time.sleep(0.2)
        seconds["listening"] = time.monotonic() - t0
        rc, state, err = cli("state")
        if rc != 0 or "MonitorState" not in state:
            fail(f"main: cccli state exited {rc}: {err or state}")
        t1, retries = time.monotonic(), 0
        while True:
            rc, proposals, err = cli("proposals")
            if rc == 0:
                break
            if proposals.get("status") != 503 or time.monotonic() - t0 > MAIN_DEADLINE_S:
                fail(f"main: cccli proposals exited {rc}: {err or proposals}")
            retries += 1
            time.sleep(1.0)
        seconds["first proposals"] = time.monotonic() - t1
        rc, cluster, err = cli("kafka_cluster_state", "--verbose")
        if rc != 0:
            fail(f"main: cccli kafka_cluster_state exited {rc}: {err or cluster}")
        rc, rebalance, err = cli("rebalance", "--dryrun", "true")
        if rc != 0 or "goalSummary" not in rebalance:
            fail(f"main: cccli rebalance --dryrun true exited {rc}: {err or rebalance}")
        dead = {b["Broker"] for b in cluster["KafkaBrokerState"] if b["BrokerState"] == "DEAD"}
        replicas = {p["topicPartition"]: p["replicas"] for p in cluster["KafkaPartitionState"]}
        for p in proposals["proposals"]:
            if replicas.get(p["topicPartition"]) != p["oldReplicas"]:
                fail(f"main: proposal {p['topicPartition']} does not start from the cluster's "
                     f"replicas {replicas.get(p['topicPartition'])}")
            replicas[p["topicPartition"]] = p["newReplicas"]
        on_dead = sum(b in dead for r in replicas.values() for b in r)
        if on_dead:
            fail(f"main: {on_dead} replicas left on dead brokers after the proposals")
        with urllib.request.urlopen(url + "/perf", timeout=120) as resp:
            perf = json.loads(resp.read().decode())
        with urllib.request.urlopen(url + "/metrics", timeout=120) as resp:
            metrics = resp.read().decode()
        fp, mem = perf["fingerprint"], perf["memory"]
        if fp.get("platform") != "gpu" or fp.get("deviceKind") != name or \
                mem.get("peakBytesInUse", 0) <= 0 or mem.get("fallback") != 0:
            fail(f"main: /perf does not name the card or shows no device-memory peak: {fp}, "
                 f"{mem}")
        libraries = sorted((p["library"], p["built"]) for p in perf["programs"])
        import re

        solves = re.search(r'cruise_control_latency_seconds_count\{sensor="GoalOptimizer\.'
                           r'proposal-computation-timer"\} (\d+)', metrics)
        if solves is None or int(solves.group(1)) < 1:
            fail("main: /metrics counts no proposal computation")
        t2 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=MAIN_SIGINT_S)
        except subprocess.TimeoutExpired:
            fail(f"main: the service did not stop within {MAIN_SIGINT_S} s of SIGINT")
        seconds["stop after SIGINT"] = time.monotonic() - t2
        if rc != 0:
            fail(f"main: the service exited {rc} after SIGINT:\n{output()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    print(f"main: {len(proposals['proposals'])} proposals over {len(replicas)} partitions replay "
          f"from the cluster's assignment, none on the {len(dead)} dead brokers; rebalance "
          f"--dryrun true: {rebalance['summary']['numReplicaMovements']} replica moves; the "
          f"monitor's first window after {retries} typed 503s")
    print(f"main: /perf names {fp['deviceKind']} ({fp['deviceCount']} card, torch {fp['torch']}, "
          f"CUDA {fp['cuda']}), device-memory peak {mem['peakBytesInUse'] / 2**20:.1f} MiB; "
          f"kernel libraries (name, built by nvcc) {libraries}; /metrics counts "
          f"{solves.group(1)} solves; stopped {seconds['stop after SIGINT']:.2f} s after SIGINT")
    print("main: host seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()) +
          f" ({card})")
    return dict(seconds=seconds, solves=int(solves.group(1)), libraries=libraries,
                retries=retries, peak_bytes=mem["peakBytesInUse"])


def merge_records(kind: str, n_dev: int, k_loc: int, rng):
    """Phase 23's K12 input: the [n_dev * k_loc] records a mesh of n_dev
    shards gathers, each shard's k_loc (score f32, global partition i32 in
    its 10,079-row block, kind, slot, dst), as CPU tensors."""
    n = n_dev * k_loc
    p = np.concatenate([np.sort(rng.choice(10079, k_loc, replace=False)) + 10079 * d
                        for d in range(n_dev)]).astype(np.int32)
    if kind == "random":
        s = rng.standard_normal(n).astype(np.float32)
    elif kind == "equal scores across shards":
        s = rng.choice(np.float32([2.5, 0.125, -1.0]), n).astype(np.float32)
    elif kind == "-0.0 against +0.0":
        s = rng.choice(np.float32([0.0, -0.0, -1.0]), n).astype(np.float32)
    elif kind == "shards all -inf":
        s = rng.standard_normal(n).astype(np.float32)
        s[: (n_dev // 2) * k_loc] = -np.inf
    else:
        s = np.full(n, -np.inf, np.float32)
    rest = np.stack([rng.integers(0, 2, n), rng.integers(0, 3, n), rng.integers(0, 520, n)], 1)
    return (torch.from_numpy(s),
            torch.from_numpy(np.concatenate([p[:, None], rest.astype(np.int32)], axis=1)))


def mesh_phase(model_cpu, parity_model, card: str, row, run_and_check, solves,
               device="cuda:0") -> dict:
    """Phase 23: the partition-axis mesh on one card, its shards row blocks
    of cuda:0 (parallel/sharding.make_mesh may name a device several times).
    (a) K12 bit-equal to its plain version on MESH_MERGE_SHAPES x
    MESH_MERGE_KINDS at k_sel 1, k_loc and every record, and timed at (b)'s
    shape; K13 on the smoke model padded to 8 shards (199,520 rows)
    bit-equal to its plain version and to the host's counts, and timed; the
    sharded shortlist on 8 row blocks at the smoke model's full greedy grid
    (phase 3's hard goal with dead brokers and LeaderReplicaDistributionGoal)
    equal to the unsharded K9 and to the plain sharded version, bit for bit,
    its 8 K9 launches and K12 timed against one K9 launch. (b) The parity
    model under GREEDY_SETTINGS (pinned) on a mesh of MESH_PARITY_SHARDS:
    phase 9's JAX digest and SHA-256, K9 launched 4 times and K12 once a
    grid round, as many grid rounds as phase 9's, each gathered once
    (`collective_totals`). (c) The smoke model's bucketed service solve on
    a mesh of MESH_SERVICE_SHARDS: phase 10's JAX digest and SHA-256; K13's
    coverage certificate on its placed context equal to the host's counts
    (its own launch count, the path of the JSON line's partition_stats row);
    lane (a) under that mesh: lane (a)'s JAX digest, the lane's context
    placed again after K10. (d) `make_mesh_from_config` on the card:
    `tpu.mesh.devices=0` gives no mesh on one card, 2 raises JAX's message.
    Every shard is a row block of `device`. Returns the phase's host seconds
    and counts."""
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer import incremental as inc
    from cruise_control_torch.analyzer import optimizer as opt
    from cruise_control_torch.analyzer.acceptance import build_tables
    from cruise_control_torch.analyzer.context import (
        OptimizationOptions,
        build_static_ctx,
        compute_aggregates,
        dims_of,
    )
    from cruise_control_torch.analyzer.goals import goals_by_priority
    from cruise_control_torch.common.telemetry import TELEMETRY
    from cruise_control_torch.config import CruiseControlConfig
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist
    from cruise_control_torch.kernels.partition_stats import partition_stats, partition_stats_plain
    from cruise_control_torch.kernels.score_candidates import ScoreContext
    from cruise_control_torch.kernels.shard_merge import shard_merge, shard_merge_plain
    from cruise_control_torch.models.flat_model import from_numpy
    from cruise_control_torch.parallel import sharding, spmd

    t_phase = time.monotonic()
    dev = torch.device(device)
    out = {}

    # (a) K12 on generated record sets, against its plain version on the CPU
    rng = np.random.default_rng(SEED)
    checked = 0
    for n_dev, k_loc in MESH_MERGE_SHAPES:
        for kind in MESH_MERGE_KINDS:
            sc, rc = merge_records(kind, n_dev, k_loc, rng)
            for k_sel in sorted({1, k_loc, n_dev * k_loc}):
                want, got = shard_merge_plain(sc, rc, k_sel), shard_merge(sc.to(dev), rc.to(dev),
                                                                          k_sel)
                torch.cuda.synchronize()
                if not (bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])):
                    fail(f"mesh: K12 shard_merge ({kind}, {n_dev} x {k_loc}, k_sel {k_sel}) "
                         "differs from the plain version")
                checked += 1
    sc, rc = merge_records("equal scores across shards", MESH_PARITY_SHARDS, 1, rng)
    sg, rg = sc.to(dev), rc.to(dev)
    n12 = sc.shape[0]
    err12 = max(max_abs_err(a, b) for a, b in zip(shard_merge(sg, rg, 1),
                                                   shard_merge_plain(sc, rc, 1)))
    # a first profiler session after a long pause can hold no device time
    # (phase 3's first row shows it too): warm it up on this call
    device_ms(lambda i: shard_merge(sg, rg, 1))
    # the records read once and the winner written; n^2 comparisons
    r12 = row("shard_merge", "shard_merge.cu", "cruise_control_tpu/parallel/spmd.py:183", err12,
              lambda i: shard_merge(sg, rg, 1), lambda i: shard_merge_plain(sg, rg, 1),
              (n12 + 1) * 20, n12 * n12,
              f"one block, a thread a record ranking it against the {n12} gathered records "
              "(scores and partitions staged in shared memory), the winner written at rank 0")
    print(f"mesh: K12 shard_merge bit-equal to its plain version on {checked} record sets "
          f"(shards x records {list(MESH_MERGE_SHAPES)}, kinds {list(MESH_MERGE_KINDS)}); "
          f"{r12['ms']:.4f} ms on the device at {n12} records, {r12['call_ms']:.4f} ms per "
          f"call, plain {r12['plain_ms']:.4f} ms, bound {r12['bound_ms']:.8f} ms ({card})")

    # K13 on the smoke model padded to MESH_SERVICE_SHARDS shards
    padded = sharding.pad_partitions(model_cpu, MESH_SERVICE_SHARDS)
    dims8 = dims_of(padded)
    constraint = BalancingConstraint.default()
    st_c = build_static_ctx(padded, constraint, dims8, valid_partitions=model_cpu.num_partitions)
    padded_g = padded.to(dev)
    st_g = build_static_ctx(padded_g, constraint, dims8,
                            valid_partitions=model_cpu.num_partitions)
    agg_g = compute_aggregates(st_g, padded_g.assignment, dims8)
    p8, r = dims8.num_partitions, dims8.max_rf
    mov_g, a_g = st_g.movable_partition, agg_g.assignment
    host = [int(st_c.movable_partition.numpy().sum()), int((padded.assignment.numpy() >= 0).sum()),
            p8]
    got13 = partition_stats(mov_g, a_g)
    torch.cuda.synchronize()
    plain13 = partition_stats_plain(st_c.movable_partition, padded.assignment)
    if not bits_equal(got13, plain13) or got13.tolist() != host:
        fail(f"mesh: K13 partition_stats {got13.tolist()} differs from its plain version "
             f"{plain13.tolist()} or the host's counts {host}")
    r13 = row("partition_stats", "partition_stats.cu", "cruise_control_tpu/parallel/spmd.py:218",
              max_abs_err(got13, plain13), lambda i: partition_stats(mov_g, a_g),
              lambda i: partition_stats_plain(mov_g, a_g), p8 * (1 + 4 * r) + 12, p8 * (1 + r),
              f"[{p8}, {r}] slots and {p8} flags: one launch, block counts, an atomic a block "
              "and count, the last block writes the totals",
              library=lambda i: (torch.sum(mov_g), torch.sum(a_g >= 0)))
    print(f"mesh: K13 partition_stats on the smoke model padded to {p8} rows: {host} (movable, "
          f"populated slots, rows), bit-equal to the plain version and the host's counts; "
          f"{r13['ms']:.4f} ms on the device, {r13['call_ms']:.4f} ms per call, plain "
          f"{r13['plain_ms']:.4f} ms, two integer torch.sum {r13['library_ms']:.4f} ms, bound "
          f"{r13['bound_ms']:.6f} ms ({card})")

    # the sharded shortlist on 8 row blocks of the card at the full grid
    mesh8 = sharding.make_mesh(MESH_SERVICE_SHARDS, devices=[dev] * MESH_SERVICE_SHARDS)
    placed = sharding.place_static(st_g, mesh8)
    goals = goals_by_priority(None)
    by_name = {g.name: g for g in goals}
    out["shortlist"] = {}
    for label, goal in (("hard goal", by_name["DiskCapacityGoal"]),
                        ("leader count goal", by_name["LeaderReplicaDistributionGoal"])):
        tables = build_tables(goals[:goals.index(goal)], st_g, agg_g, dims8)
        gs = goal.prepare(st_g, agg_g, dims8)
        cands = opt.dst_candidates(st_g, gs, agg_g, goal, dims8,
                                   opt.GREEDY_SETTINGS.num_dst_candidates, tables)
        shortlist = spmd.make_grid_shortlist(mesh8, goal, dims8, opt.GREEDY_SETTINGS)
        k9, k12 = grid_shortlist.launches, shard_merge.launches
        sharded = shortlist(placed, agg_g, gs, tables, cands)
        torch.cuda.synchronize()
        if (grid_shortlist.launches - k9, shard_merge.launches - k12) != (MESH_SERVICE_SHARDS, 1):
            fail(f"mesh: the sharded shortlist ({label}) did not launch K9 once a shard and K12 "
                 "once")
        whole = grid_shortlist(st_g, agg_g, tables, goal, gs, cands)
        plain = shortlist.plain(placed, agg_g, gs, tables, cands)
        for name_, a_, b_, c_ in zip(("score", "p", "kind", "slot", "dst"), sharded, whole, plain):
            if not (bits_equal(a_, b_) and bits_equal(a_, c_)):
                fail(f"mesh: the sharded shortlist ({label}) {name_} differs from the unsharded "
                     f"K9's or the plain version's ({a_.tolist()}, {b_.tolist()}, {c_.tolist()})")
        if not bool(torch.isfinite(sharded[0]).all()):
            fail(f"mesh: the sharded shortlist ({label}) found no finite cell")
        ctx = ScoreContext(st_g, agg_g, tables, goal, gs)
        ms_sharded = device_ms(lambda i: shortlist(placed, agg_g, gs, tables, cands))
        ms_whole = device_ms(lambda i: grid_shortlist(st_g, agg_g, tables, goal, gs, cands,
                                                      ctx=ctx))
        call_sharded = time_ms(lambda i: shortlist(placed, agg_g, gs, tables, cands))
        call_whole = time_ms(lambda i: grid_shortlist(st_g, agg_g, tables, goal, gs, cands,
                                                      ctx=ctx))
        out["shortlist"][label] = {"record": [float(sharded[0])] + [int(x) for x in sharded[1:]],
                                   "ms_sharded": ms_sharded, "ms_whole": ms_whole,
                                   "call_ms_sharded": call_sharded, "call_ms_whole": call_whole}
        print(f"mesh: the shortlist ({label}) on {MESH_SERVICE_SHARDS} row blocks of "
              f"[{p8 // MESH_SERVICE_SHARDS}, {r}, {cands.shape[0]}]: p {int(sharded[1])} kind "
              f"{int(sharded[2])} slot {int(sharded[3])} dst {int(sharded[4])} score "
              f"{float(sharded[0]):.6g}, bit-equal to the unsharded K9 and the plain sharded "
              f"version; {MESH_SERVICE_SHARDS} K9 launches, the gather and K12 {ms_sharded} ms "
              f"on the device ({call_sharded:.4f} ms per call) against one K9 launch "
              f"{ms_whole} ms ({call_whole:.4f} ms per call) ({card})")
    del padded_g, st_g, agg_g, placed, mov_g, a_g

    # (b) the parity model's greedy pass on a mesh of MESH_PARITY_SHARDS
    if parity_model.num_partitions % MESH_PARITY_SHARDS:
        fail(f"mesh: the parity model's {parity_model.num_partitions} partitions are not a "
             f"multiple of {MESH_PARITY_SHARDS}")
    mesh4 = sharding.make_mesh(MESH_PARITY_SHARDS, devices=[dev] * MESH_PARITY_SHARDS)
    o4 = opt.GoalOptimizer(settings=dataclasses.replace(opt.GREEDY_SETTINGS,
                                                        chunk_target_s=PINNED_TARGET_S),
                           mesh=mesh4)
    before = TELEMETRY.collective_totals()["byOp"].get("all-gather", {"count": 0})["count"]
    res = run_and_check("mesh parity greedy", parity_model,
                        lambda: o4.optimizations(parity_model, None, raise_on_hard_failure=False),
                        MESH_PATH, JAX_CPU_PARITY_GREEDY_REFERENCE, JAX_CPU_PARITY_GREEDY_MOVES)
    gathers = TELEMETRY.collective_totals()["byOp"]["all-gather"]["count"] - before
    counts = solves["mesh parity greedy"]["launches"]
    rounds = solves["parity greedy"]["launches"]["grid_shortlist"]
    if (counts["grid_shortlist"], counts["shard_merge"], gathers) != (
            MESH_PARITY_SHARDS * rounds, rounds, rounds):
        fail(f"mesh parity greedy: K9 {counts['grid_shortlist']} and K12 "
             f"{counts['shard_merge']} launches, {gathers} gathers; phase 9 ran {rounds} grid "
             "rounds")
    if res.bucketed["paddedPartitions"]:
        fail("mesh parity greedy: the mesh padded the partition axis")
    print(f"mesh parity greedy: {rounds} grid rounds as in phase 9, each K9 x "
          f"{MESH_PARITY_SHARDS}, one all-gather and K12; {solves['mesh parity greedy']['wall_s']:.2f}"
          f" s against phase 9's {solves['parity greedy']['wall_s']:.2f} s ({card})")
    del res, o4

    # (c) the bucketed service solve and lane (a) on a mesh of MESH_SERVICE_SHARDS
    pinned = dataclasses.replace(opt.SERVICE_SETTINGS, chunk_target_s=PINNED_TARGET_S)
    o8 = opt.GoalOptimizer(settings=pinned, mesh=mesh8)
    res = run_and_check("mesh service bucketed", model_cpu,
                        lambda: o8.optimizations(model_cpu, None, raise_on_hard_failure=False),
                        STACK_PATH, JAX_CPU_SERVICE_BUCKETED_REFERENCE,
                        JAX_CPU_SERVICE_BUCKETED_MOVES)
    if res.bucketed != JAX_CPU_SERVICE_BUCKETED_BLOCK:
        fail("mesh service bucketed: the bucket record differs from the JAX CPU run's")
    del res
    options = OptimizationOptions()
    p_orig, pmodel, dims_s, static, static_canon, _ = o8.prepared_entry(model_cpu, options)
    if not (isinstance(static, sharding.PlacedStatic) and static.mesh == mesh8):
        fail("mesh service bucketed: the prepared context is not placed on the mesh")
    agg_s = compute_aggregates(static_canon, pmodel.assignment, dims_s)
    host = [int(static_canon.movable_partition.sum()), int((pmodel.assignment >= 0).sum()),
            dims_s.num_partitions]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.monotonic()
    got = [int(x) for x in spmd.make_partition_stats(mesh8)(static, agg_s)]
    torch.cuda.synchronize()
    solves["mesh certificate"] = {"launches": kernels.launches(), "wall_s": time.monotonic() - t0,
                                  "counts": got}
    if got != host or solves["mesh certificate"]["launches"]["partition_stats"] != \
            MESH_SERVICE_SHARDS:
        fail(f"mesh certificate: {got} against the host's {host}, K13 launched "
             f"{solves['mesh certificate']['launches']['partition_stats']} times")
    print(f"mesh certificate: K13 on the {MESH_SERVICE_SHARDS} shards of the placed service "
          f"context, summed: {got} (movable, populated slots, rows), the host's counts")
    del agg_s
    lane = inc.IncrementalLane(o8)
    if not lane.arm(model_cpu, options, [g.name for g in goals], generation=1):
        fail("mesh lane a: the mesh service solve left no prep-cache entry to arm from")
    lane_a, _ = lane_perturbations({k: v.numpy() for k, v in model_cpu._asdict().items()})
    fresh = from_numpy(lane_a)

    def propose():
        outcome = lane.propose(fresh, generation=2)
        if not outcome.ok:
            fail(f"mesh lane a: the proposal fell back ({outcome.fallback_reason})")
        return outcome.result

    run_and_check("mesh lane a", fresh, propose, LANE_PATH, JAX_CPU_LANE_A_REFERENCE,
                  JAX_CPU_LANE_A_MOVES)
    armed = lane._armed.static
    if not (isinstance(armed, sharding.PlacedStatic) and armed.mesh == mesh8):
        fail("mesh lane a: the lane's context was not placed on the mesh again after K10")
    print(f"mesh lane a: K10 scattered into the canonical context and the lane placed it on "
          f"the {MESH_SERVICE_SHARDS} shards again; {solves['mesh lane a']['wall_s']:.2f} s "
          f"against phase 12's {solves['lane a']['wall_s']:.2f} s ({card})")
    del lane, o8, static, static_canon, pmodel, fresh

    # (d) the configuration's mesh on this machine
    count = torch.cuda.device_count()
    auto = sharding.make_mesh_from_config(CruiseControlConfig({"tpu.mesh.devices": "0"}))
    print(f"mesh config: tpu.mesh.devices=0 on {count} card(s) -> "
          f"{'no mesh' if auto is None else auto}")
    if count == 1 and auto is not None:
        fail("mesh config: tpu.mesh.devices=0 made a mesh of one card")
    try:
        two = sharding.make_mesh_from_config(CruiseControlConfig({"tpu.mesh.devices": "2"}))
        print(f"mesh config: tpu.mesh.devices=2 -> {two}")
        if count < 2:
            fail("mesh config: tpu.mesh.devices=2 made a mesh on one card")
    except ValueError as e:
        print(f"mesh config: tpu.mesh.devices=2 -> ValueError: {e}")
        if str(e) != f"need 2 devices, have {count}":
            fail(f"mesh config: the refusal differs from the JAX package's message: {e}")
    totals = TELEMETRY.collective_totals()
    print(f"mesh: collective totals {json.dumps(totals)}")
    out.update(seconds=time.monotonic() - t_phase, k12_record_sets=checked, collectives=totals)
    print(f"mesh: phase 23 took {out['seconds']:.1f} s ({card})")
    return out


def executed_phase(res, model_m, meta_m, sim_m, monitor_m, card: str) -> dict:
    """Phase 19 on phase 18's result, model, metadata, simulator and monitor:
    stamp, execute, check against JAX_CPU_EXECUTED, rebuild the model, run
    the chaos harness, check against JAX_CPU_CHAOS, print the host seconds.
    Returns those seconds and both records; any failed check exits."""
    from types import SimpleNamespace

    from cruise_control_torch.common.tracing import TRACER
    from cruise_control_torch.config import CruiseControlConfig
    from cruise_control_torch.executor import (
        Executor,
        ExecutorConfig,
        SimulatorClusterDriver,
        TopologyFingerprint,
    )
    from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
    from cruise_control_torch.testing.chaos import ChaosHarness, ChaosPlan, Perturbation
    from cruise_control_torch.testing.simulator import SimulatedCluster

    exec_ns = SimpleNamespace(
        SimulatedCluster=SimulatedCluster, Executor=Executor, ExecutorConfig=ExecutorConfig,
        SimulatorClusterDriver=SimulatorClusterDriver, TopologyFingerprint=TopologyFingerprint,
        CruiseControlConfig=CruiseControlConfig, ChaosHarness=ChaosHarness, ChaosPlan=ChaosPlan,
        Perturbation=Perturbation)
    t0 = time.perf_counter()
    stamp(res, monitor_m, meta_m, exec_ns)
    stamp_s = time.perf_counter() - t0
    print(f"executed: stamped generation {res.generation}, fingerprint "
          f"{json.dumps(res.fingerprint.to_dict())}, {len(res.proposals)} proposals named")
    summary, batches, paused, exec_s = execute_monitored(res, sim_m, monitor_m, exec_ns)
    v = summary["proposalValidation"]
    spans = {sp["name"]: sp["durationS"] for sp in reversed(TRACER.recent(limit=4096))
             if sp["kind"] in ("validation", "executor")}
    after = sim_m.fetch_topology().assignment
    rec = execution_record(summary, after, batches)
    print(f"executed: {json.dumps(rec)}")
    print("executed: proposal validation "
          f"{json.dumps({k: x for k, x in v.items() if k != 'trimmed'})}")
    for key, want in JAX_CPU_EXECUTED.items():
        if rec[key] != want:
            fail(f"executed: {key} {rec[key]} differs from the JAX executor's {want}")
    print("executed: per-state counts, trims, dispatch order and the simulator's assignment "
          "equal the JAX executor's run of the JAX solve's proposals")
    by = rec["byState"]
    if by["PENDING"] or by["IN_PROGRESS"] or by["ABORTING"] or rec["numInProgressMovements"]:
        fail(f"executed: tasks left non-terminal {by}")
    if by["COMPLETED"] != rec["numTotalMovements"] or summary["failedTasks"]:
        fail(f"executed: not every task completed {by}")
    if not paused or not all(paused) or monitor_m.sampling_paused:
        fail("executed: the monitor's sampling was not paused through every dispatch and "
             "resumed after")
    print(f"executed: sampling paused at all {len(paused)} dispatches, resumed after "
          f"(monitor state {monitor_m.state})")
    want = res.final_assignment
    same = all(set(x[x >= 0]) == set(w[w >= 0]) for x, w in zip(after, want)) and bool(
        (after[:, 0] == want[:, 0]).all())
    print(f"executed: the simulator's assignment {'equals' if same else 'DIFFERS from'} the "
          "solve's final assignment as replica sets with their leaders")
    rebuilt, _ = monitor_m.cluster_model(ModelCompletenessRequirements(
        min_required_num_windows=1, min_monitored_partitions_percentage=0.5))
    if not np.array_equal(rebuilt.assignment.numpy(), after):
        fail("executed: the model rebuilt from the monitor does not hold the executed "
             "assignment")
    print("executed: the model rebuilt by the monitor holds the executed assignment")
    victim, csummary, harness, chaos_s = chaos_run(model_m, res, exec_ns)
    crec = execution_record(csummary, harness.sim.fetch_topology().assignment)
    print(f"executed: chaos (broker {victim} killed at poll {CHAOS_KILL_POLL}): "
          f"{json.dumps(crec)}")
    violations = harness.checker.violations + harness.checker.check_final()
    if violations:
        fail(f"executed: chaos invariant violations {violations[:5]}")
    cby = crec["byState"]
    if cby["PENDING"] or cby["IN_PROGRESS"] or cby["ABORTING"]:
        fail(f"executed: chaos left tasks non-terminal {cby}")
    for key, want in JAX_CPU_CHAOS.items():
        if crec[key] != want:
            fail(f"executed: chaos {key} {crec[key]} differs from the JAX run's {want}")
    print("executed: chaos run holds every invariant and equals the JAX run's counts and trims")
    print(f"executed: host seconds: stamping {stamp_s:.3f}, admission "
          f"{spans.get('proposal-admission', 0.0):.3f}, execution {exec_s:.3f} (replica phase "
          f"{spans.get('executor.replica-movement-phase', 0.0):.3f}, leadership phase "
          f"{spans.get('executor.leadership-movement-phase', 0.0):.3f}, validation "
          f"{v['overheadS']:.3f}), chaos {chaos_s:.3f}; {rec['numTotalMovements']} tasks in "
          f"{rec['batches']} batches ({card})")
    return dict(stamp_s=stamp_s, admission_s=spans.get("proposal-admission"),
                execution_s=exec_s, chaos_s=chaos_s, record=rec, chaos=crec)


def model_sha256(fields: dict) -> dict:
    """{field: SHA-256 of its bytes} of a model's numpy fields, in the
    model's field order (int32 and float32, C order)."""
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in fields.items()}


#: device and call ms at chip_smoke's rows in the designs they replaced
#: (K2: one atomicMax pass per k; window_sum: one block per column; K1: two
#: library sorts and a thread per broker; K8: one block per topic, then one
#: block for the seven series; K7: one block of scalar loads and a
#: shared-memory tree; K10: every thread scanning the whole batch; K11: a
#: thread a partition, its slots and flags read from device memory), as
#: PERF.md section 6 records them, printed beside the new times
PREVIOUS_MS = {"disk drain": (0.143, 0.170), "leader bytes-in": (0.0034, 0.0284),
               "broker loads": (0.0035, 0.0271), "partition leader bytes-in": (0.1087, 0.1112),
               "K1 smoke model": (0.481, 0.532), "K8 4000 topics": (0.184, 0.191),
               "K7 smoke model": (0.0041, 0.0418), "K10 64 rows": (0.0126, 0.204),
               "K11 smoke model": (0.0043, 0.0198)}


def previous(label: str) -> str:
    if label not in PREVIOUS_MS:
        return "no row of the previous design"
    ms, call_ms = PREVIOUS_MS[label]
    return f"previous design {ms:.4f} ms on the device, {call_ms:.4f} ms per call (PERF.md)"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(call, reps: int = REPS) -> float:
    """Milliseconds per call: one CUDA event pair around `reps` back-to-back
    calls, after WARMUP calls. `call(i)` is given the call's number (0 ..
    WARMUP + reps - 1). A call whose host work outlasts its device work is
    timed at its host rate: this is what a caller pays per call."""
    for i in range(WARMUP):
        call(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        call(WARMUP + i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(call, reps: int = REPS):
    """Device milliseconds per call of everything `call` launches (kernels,
    copies, memsets), summed from a torch.profiler trace of `reps` calls
    after WARMUP calls; the host's share of a call is left out. None when the
    trace holds no device time."""
    for i in range(WARMUP):
        call(i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            call(WARMUP + i)
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        # CPU-side ops also report the device time of what they launched
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us += float(getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0)))
    return us / reps / 1e3 if us > 0 else None


def bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    x, y = x.detach().cpu().contiguous(), y.detach().cpu().contiguous()
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    """Largest |x - y| where both are finite (integers and flags included)."""
    x, y = x.detach().cpu().double(), y.detach().cpu().double()
    both = torch.isfinite(x) & torch.isfinite(y)
    if not both.any():
        return 0.0
    return float((x[both] - y[both]).abs().max())


def parity_gate(batched, greedy) -> dict:
    """bench.py's parity gate (_parity_block, :546-580): the batched pass
    violates no goal the greedy pass satisfies, no goal's final cost exceeds
    the greedy's by more than 5% and by more than 1% of its entry cost, and
    no goal's violated-broker count by more than 3."""
    batched_after = set(batched.violated_goals_after)
    greedy_after = set(greedy.violated_goals_after)
    regressed, count_worse, delta = [], [], {}
    for bg, gg in zip(batched.goal_results, greedy.goal_results, strict=True):
        d = bg.cost_after - gg.cost_after
        delta[bg.name] = d
        if d > PARITY_COST_REL * max(abs(gg.cost_after), 1e-9) and (
                d > PARITY_COST_FLOOR * max(gg.cost_before, 1.0)):
            regressed.append(bg.name)
        if bg.violated_brokers_after > gg.violated_brokers_after + PARITY_COUNT_SLACK:
            count_worse.append(bg.name)
    worse = sorted(batched_after - greedy_after)
    return {"greedyViolatedAfter": sorted(greedy_after),
            "batchedViolatedAfter": sorted(batched_after), "batchedWorseGoals": worse,
            "costRegressedGoals": regressed, "countRegressedGoals": count_worse,
            "costAfterDeltaVsGreedy": delta,
            "greedyCapBoundGoals": [g.name for g in greedy.goal_results if not g.converged],
            "parityOk": not worse and not regressed and not count_worse}


def main() -> int:
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer import optimizer as opt
    from cruise_control_torch.analyzer.acceptance import build_tables
    from cruise_control_torch.analyzer.actions import KIND_MOVE, leadership_grid, make_move_batch
    from cruise_control_torch.analyzer.context import (
        build_static_ctx,
        compute_aggregates,
        dims_of,
        replicas_on_dead,
    )
    from cruise_control_torch.analyzer.drain import (
        heavy_picks,
        rack_diverse_cold,
        relay_grid,
        select_surplus_pairs,
        top_k,
        topic_swap_grid,
    )
    from cruise_control_torch.analyzer.goals import (
        HARD_GOAL_NAMES,
        elect_preferred_leaders,
        goals_by_priority,
    )
    from cruise_control_torch.analyzer.swaps import swap_grid
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.kernels import build
    from cruise_control_torch.kernels.apply_wave import apply_wave, apply_wave_plain
    from cruise_control_torch.kernels.broker_topk import broker_topk, broker_topk_plain
    from cruise_control_torch.kernels.pair_picks import pair_picks, pair_picks_plain
    from cruise_control_torch.kernels.score_swaps import (
        LEADERSHIP_RELAY,
        REPLICA_SWAP,
        TOPIC_SWAP,
        score_swaps,
        score_swaps_plain,
        swap_context,
    )
    from cruise_control_torch.kernels.cluster_stats import cluster_stats, cluster_stats_plain
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain
    from cruise_control_torch.kernels.state_fingerprint import (
        state_fingerprint,
        state_fingerprint_plain,
    )
    from cruise_control_torch.kernels.window_sum import window_sum, window_sum_plain
    from cruise_control_torch.kernels.score_candidates import (
        ScoreContext,
        score_candidates,
        score_candidates_plain,
    )
    from cruise_control_torch.kernels.segment_aggregates import (
        segment_aggregates,
        segment_aggregates_plain,
    )
    from cruise_control_torch.models import generators
    from cruise_control_torch.models.flat_model import from_numpy, sanity_check

    # -- 1. device -----------------------------------------------------------
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build --------------------------------------------------------------
    build_s = build.build_all()
    print(f"build: {len(build.KERNEL_SOURCES)} kernels in {build_s:.2f} s (set-up time)")

    # -- 3. kernels at the slice's shapes --------------------------------------
    prop = dataclasses.replace(generators.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    t0 = time.monotonic()
    model_cpu = generators.random_cluster(SEED, prop)
    print(f"model: {model_cpu.num_brokers} brokers, {model_cpu.num_partitions} partitions, "
          f"RF {model_cpu.max_replication_factor}, "
          f"{int((model_cpu.broker_state == 3).sum())} dead "
          f"(generated in {time.monotonic() - t0:.1f} s)")
    model = model_cpu.to(dev)
    dims = dims_of(model_cpu)
    constraint = BalancingConstraint.default()
    st_g = build_static_ctx(model, constraint, dims)
    st_c = build_static_ctx(model_cpu, constraint, dims)
    p_count, r = dims.num_partitions, dims.max_rf
    rows = {}

    def bound(nbytes, nops):
        """(ms, by): the larger of the byte time and the operation time."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def row(key, route_src, replaces, out_cmp, call, plain, nbytes, nops, note, library=None):
        """The kernel's JSON row. `ms` is the device time per call of what
        the wrapper launches; `call_ms` the time per call of back-to-back
        wrapper calls, host work included; `plain_ms` the same for the plain
        version on the card; `library_ms` the same for the one PyTorch call
        that computes the same function, where there is one."""
        ms, call_ms, plain_ms = device_ms(call), time_ms(call), time_ms(plain)
        library_ms = time_ms(library) if library is not None else None
        if ms is None:
            print(f"{key}: the profiler trace holds no device time; ms is the CUDA-event time")
            ms = call_ms
        bound_ms, bound_by = bound(nbytes, nops)
        rows[key] = {
            "name": key, "route": "cuda", "source": f"cruise_control_torch/csrc/{route_src}",
            "replaces": replaces, "launches": 0, "max_abs_err": out_cmp, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms, "note": note,
        }
        return rows[key]

    # K10 first (the newest kernel): a 64-row batch into the smoke model's
    # bucketed context, 212,992 partitions by 3,072 brokers, as the lane holds
    # it. The batch: lane_perturbations' (a) (one topic's load spike and
    # LANE_ADDS partition adds), a broker death, a revival and a demotion,
    # then NOOP rows.
    from cruise_control_torch.analyzer import incremental as inc
    from cruise_control_torch.kernels.delta_scatter import delta_scatter, delta_scatter_plain
    from cruise_control_torch.kernels.elect_preferred import elect_preferred, elect_preferred_plain

    state_np = model_cpu.broker_state.numpy()
    alive_np, dead_np = np.nonzero(state_np == 0)[0], np.nonzero(state_np == 3)[0]
    lane_fields, _ = lane_perturbations({k: v.numpy() for k, v in model_cpu._asdict().items()})
    deltas, reason = inc.derive_deltas(model_cpu, from_numpy(lane_fields))
    if reason is not None:
        fail(f"K10 delta_scatter: the lane's perturbation is not a delta batch ({reason})")
    deltas += [inc.ModelDelta(kind=inc.DELTA_BROKER_DEATH, broker=int(alive_np[0]), state=3),
               inc.ModelDelta(kind=inc.DELTA_BROKER_REVIVAL, broker=int(dead_np[0]), state=1),
               inc.ModelDelta(kind=inc.DELTA_BROKER_STATE, broker=int(alive_np[1]), state=2)]
    d10 = inc.IncrementalConfig().max_deltas
    ctx10_g = opt.GoalOptimizer(device="cuda", settings=opt.SERVICE_SETTINGS)._build_ctx(model_cpu)
    ctx10_c = opt.GoalOptimizer(device="cpu", settings=opt.SERVICE_SETTINGS)._build_ctx(model_cpu)
    st10_g, st10_c = ctx10_g[3], ctx10_c[3]
    b10, (p10, m10) = ctx10_g[2].num_brokers, tuple(st10_c.part_load.shape)
    base10_c = torch.arange(b10) < model_cpu.num_brokers
    base10_g = base10_c.to(dev)
    batch10_c = inc.build_delta_batch(deltas, d10, m10)
    batch10_g = inc.build_delta_batch(deltas, d10, m10, dev)
    inputs10 = [t.clone() for t in st10_g]
    out10_g = delta_scatter(st10_g, batch10_g, base10_g, base10_g)
    torch.cuda.synchronize()
    out10_c = delta_scatter_plain(st10_c, batch10_c, base10_c, base10_c)
    for n_ in out10_c._fields:
        if not bits_equal(getattr(out10_g, n_), getattr(out10_c, n_)):
            fail(f"K10 delta_scatter: {n_} differs from the plain version")
    if not all(torch.equal(x, y) for x, y in zip(inputs10, st10_g)):
        fail("K10 delta_scatter: the input context changed")
    changed = int((out10_c.part_load != st10_c.part_load).any(dim=1).sum())

    def k10_row(label, key, batch_g, d_):
        """K10's row for a d_-row batch into the bucketed context. Bytes: the
        batch once, the broker state, validity and two base masks, the
        part_load and topic_id columns, the count; out: the state and six
        masks, the two columns, the count. Operations, what the function
        needs whatever implements it: three target tests a batch row, one
        select an element written."""
        nbytes = (d_ * (5 * 4 + m10 * 4) + b10 * (4 + 3) + 2 * p10 * (m10 * 4 + 4)
                  + b10 * (4 + 6) + 2 * 4)
        nops = 3 * d_ + p10 * (m10 + 1) + 7 * b10 + 1
        rw = row(key, "delta_scatter.cu", "cruise_control_tpu/analyzer/incremental.py:162",
                 0.0, lambda i: delta_scatter(st10_g, batch_g, base10_g, base10_g),
                 lambda i: delta_scatter_plain(st10_g, batch_g, base10_g, base10_g), nbytes,
                 nops, f"{label} into [{p10}, {m10}] x {b10}: a block a tile of 512 rows "
                 "and brokers resolves its last writers once by shared-memory atomicMax, then "
                 "copies the tile flat in 16-byte vectors; fresh outputs")
        print(f"K10 delta_scatter ({label}): {rw['ms']:.4f} ms on the device, "
              f"{rw['call_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, bound "
              f"{rw['bound_ms']:.6f} ms; {previous('K10 ' + str(d_) + ' rows')}")
        return rw

    k10_row(f"{len(deltas)} deltas in a {d10}-row batch", "delta_scatter", batch10_g, d10)
    print(f"K10 delta_scatter: {len(deltas)} deltas ({changed} load rows changed) into the "
          f"[{p10}, {m10}] x {b10} bucketed context, every field bit-equal to the plain version, "
          "the input context unchanged")
    # a 4,096-row batch of random kinds and targets (repeated ones, about
    # half counted from the end, a few outside the axes)
    rng10 = np.random.default_rng(SEED)
    d_big = 4096
    cols10 = {"kind": rng10.integers(0, 4, d_big),
              "broker": rng10.integers(-b10 - 4, b10 + 4, d_big),
              "state": rng10.integers(0, 4, d_big),
              "row": rng10.integers(-p10 - 4, p10 + 4, d_big),
              "topic": rng10.integers(0, 4000, d_big)}
    big_c = inc.DeltaBatch(**{k: torch.from_numpy(v.astype(np.int32)) for k, v in cols10.items()},
                           load=torch.from_numpy(rng10.random((d_big, m10), dtype=np.float32)))
    big_g = inc.DeltaBatch(*(t.to(dev) for t in big_c))
    big_out_g = delta_scatter(st10_g, big_g, base10_g, base10_g)
    torch.cuda.synchronize()
    big_out_c = delta_scatter_plain(st10_c, big_c, base10_c, base10_c)
    for n_ in big_out_c._fields:
        if not bits_equal(getattr(big_out_g, n_), getattr(big_out_c, n_)):
            fail(f"K10 delta_scatter ({d_big}-row batch): {n_} differs from the plain version")
    if not all(torch.equal(x, y) for x, y in zip(inputs10, st10_g)):
        fail(f"K10 delta_scatter ({d_big}-row batch): the input context changed")
    k10_row(f"a random {d_big}-row batch", "delta_scatter 4096 rows", big_g, d_big)
    rows.pop("delta_scatter 4096 rows")
    print(f"K10 delta_scatter ({d_big}-row batch): every field bit-equal to the plain version, "
          "the input context unchanged")
    rows["delta_scatter"]["max_abs_err"] = max(
        max_abs_err(getattr(out10_g, n_), getattr(out10_c, n_)) for n_ in out10_c._fields)
    del st10_g, out10_g, inputs10, big_g, big_out_g

    # K1 on the smoke model (the JSON row), on its bucketed service context
    # (212,992 x 3 slots over 3,072 brokers, the main path's shape) and on
    # the smoke model with half its slots moved to broker 0 (one broker
    # takes its block's four warps)
    names = ("broker_load", "replica_count", "leader_count", "potential_nw_out",
             "leader_nw_in", "rack_replica_count", "topic_replica_count", "host_cpu_load")

    def k1_row(label, key, a_g, a_c, st_g_, st_c_, dims_):
        args_g = (a_g, st_g_.part_load, st_g_.topic_id, st_g_.broker_rack, st_g_.broker_host,
                  dims_.num_brokers, dims_.num_racks, dims_.num_hosts, dims_.num_topics)
        args_c = (a_c, st_c_.part_load, st_c_.topic_id, st_c_.broker_rack, st_c_.broker_host,
                  dims_.num_brokers, dims_.num_racks, dims_.num_hosts, dims_.num_topics)
        out_g = segment_aggregates(*args_g)
        torch.cuda.synchronize()
        out_c = segment_aggregates_plain(*args_c)
        for n_, a_, b_ in zip(names, out_g, out_c):
            if not bits_equal(a_, b_):
                fail(f"K1 segment_aggregates ({label}): {n_} differs from the plain version")
        p_, r_ = a_c.shape
        nbytes = (a_c.numel() * 4 + st_c_.part_load.numel() * 4 + p_ * 4
                  + dims_.num_brokers * 8 + sum(t.numel() * 4 for t in out_c))
        # per slot: 4 load adds, potential NW_OUT, leader NW_IN, 4 counts
        rw = row(key, "segment_aggregates.cu", "cruise_control_tpu/analyzer/context.py:276",
                 max(max_abs_err(a_, b_) for a_, b_ in zip(out_g, out_c)),
                 lambda i: segment_aggregates(*args_g), lambda i: segment_aggregates_plain(*args_g),
                 nbytes, p_ * r_ * 10 + dims_.num_brokers,
                 f"{label}: slots bucketed by broker in blocks of 4,096 (a stable block radix "
                 "sort, a runs table), a warp per broker sums its runs in slot order (a "
                 "block for a heavy broker) and counts the topic table by atomics after a "
                 "memset, rack rows written whole from shared-memory tiles")
        print(f"K1 segment_aggregates ({label}): bit-equal to the plain version; "
              f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, plain "
              f"{rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms; "
              f"{previous('K1 ' + label)}")
        return rw

    k1_row("smoke model", "segment_aggregates", model.assignment, model_cpu.assignment, st_g, st_c,
           dims)
    pm10_g, dims10 = ctx10_g[1], ctx10_g[2]
    k1_row("bucketed", "segment_aggregates bucketed", pm10_g.assignment, ctx10_c[1].assignment,
           ctx10_g[3], ctx10_c[3], dims10)
    rows.pop("segment_aggregates bucketed")
    skew_c = model_cpu.assignment.clone()
    half = torch.from_numpy(np.random.default_rng(SEED).random(tuple(skew_c.shape)) < 0.5)
    skew_c[half & (skew_c >= 0)] = 0
    k1_row("skewed, broker 0 holds half the slots", "segment_aggregates skewed",
           skew_c.to(dev), skew_c, st_g, st_c, dims)
    rows.pop("segment_aggregates skewed")
    del pm10_g, skew_c, half

    agg_g = compute_aggregates(st_g, model.assignment, dims)
    agg_c = compute_aggregates(st_c, model_cpu.assignment, dims)
    goals = goals_by_priority(None)
    by_name = {g.name: g for g in goals}
    disk_goal, cpu_goal = by_name["DiskCapacityGoal"], by_name["CpuCapacityGoal"]

    ka_goals = goals_by_priority(KAFKA_ASSIGNER_NAMES)

    def priors(goal, st, agg):
        """The merged tables of the goals before `goal` in its stack."""
        stack = goals if goal in goals else ka_goals
        return build_tables(stack[:stack.index(goal)], st, agg, dims)

    def drain_contrib(goal, st, agg):
        gs = goal.prepare(st, agg, dims)
        c = goal.drain_contrib(st, gs, agg)
        return torch.where(replicas_on_dead(st, agg.assignment),
                           torch.tensor(1e9, dtype=torch.float32, device=c.device), c).contiguous()

    # K2 on DiskCapacityGoal's first-round drain priorities
    def disk_contrib(st, agg):
        return drain_contrib(disk_goal, st, agg)

    con_g, con_c = disk_contrib(st_g, agg_g), disk_contrib(st_c, agg_c)

    def k2_row(label, key, cg, cc, ag, ac, mg, mc, k, nb, heaviest):
        """Hold K2 on (cg, ag, mg) to its plain version on (cc, ac, mc), time
        it, print it beside the previous design's times where PREVIOUS_MS has
        them, and return its row."""
        out_g = broker_topk(cg, ag, mg, k, nb, heaviest)
        torch.cuda.synchronize()
        out_c = broker_topk_plain(cc, ac, mc, k, nb, heaviest)
        for n_, a_, b_ in zip(("p", "slot", "valid"), out_g, out_c):
            if not bits_equal(a_, b_):
                fail(f"K2 broker_topk ({label}): {n_} differs from the plain version")
        n_slots = ac.numel()
        # each input read once, the [B, k] outputs written once; per slot
        # and pass of the reference, one compare and one select
        rw = row(key, "broker_topk.cu", "cruise_control_tpu/analyzer/drain.py:74",
                 max(max_abs_err(a_, b_) for a_, b_ in zip(out_g, out_c)),
                 lambda i: broker_topk(cg, ag, mg, k, nb, heaviest),
                 lambda i: broker_topk_plain(cg, ag, mg, k, nb, heaviest),
                 n_slots * 8 + mc.numel() + nb * k * 9, k * n_slots * 2,
                 f"{label}: k = {k} of {n_slots} slots over {nb} brokers; blocks of 4,096 slots "
                 "write their keys sorted by broker as runs, a warp per broker selects from "
                 "its runs")
        print(f"K2 broker_topk ({label}, k = {k}, {nb} brokers, {int(out_c[2].sum())} of "
              f"{out_c[2].numel()} valid): bit-equal to the plain version; {rw['ms']:.4f} ms on "
              f"the device, {rw['call_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, bound "
              f"{rw['bound_ms']:.6f} ms; {previous(label)}")
        return rw

    # the JSON row: DiskCapacityGoal's drain priorities (1e9 on the dead
    # brokers' replicas), k = 8; then the same lightest first, and the
    # relay's leadership-masked weights (drain.py relay_grid: only leaders
    # compete, the round's jitter, k2 = 8 halved, lightest first)
    k2_row("disk drain", "broker_topk", con_g, con_c, agg_g.assignment, agg_c.assignment,
           st_g.movable_partition, st_c.movable_partition, 8, dims.num_brokers, True)
    k2_row("disk drain, lightest", "broker_topk lightest", con_g, con_c, agg_g.assignment,
           agg_c.assignment, st_g.movable_partition, st_c.movable_partition, 8,
           dims.num_brokers, False)

    def lead_weights(st, agg):
        from cruise_control_torch.analyzer.drain import round_jitter
        from cruise_control_torch.common.resources import PartMetric

        dev_ = agg.assignment.device
        is_leader = (torch.arange(r, device=dev_) == 0)[None, :]
        rot = round_jitter(p_count, 0, dev_)
        w_all = st.part_load[:, PartMetric.NW_IN_LEADER]
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev_)
        return (torch.where(is_leader, w_all[:, None], neg_inf) * rot[:, None]).contiguous()

    k2_row("leadership-masked", "broker_topk leadership", lead_weights(st_g, agg_g),
           lead_weights(st_c, agg_c), agg_g.assignment, agg_c.assignment,
           st_g.movable_partition, st_c.movable_partition, 4, dims.num_brokers, False)
    for key in ("broker_topk lightest", "broker_topk leadership"):
        rows.pop(key)

    # K3 on DiskCapacityGoal's first-round [512, 8, 64] move grid and the
    # [P, 2] promotion grid under CpuCapacityGoal
    def drain_grid(goal, st, agg):
        """The goal's first-round [512, 8, 64] drain grid (drain.make_drain_round)."""
        gs = goal.prepare(st, agg, dims)
        tables = priors(goal, st, agg)
        rank = goal.src_rank(st, gs, agg)
        rank = torch.where(st.dead, torch.tensor(torch.inf, device=rank.device), rank)
        _, hot = top_k(rank, 512)
        cp, cs, _ = heavy_picks(st, agg, drain_contrib(goal, st, agg), hot, 8, dims.num_brokers)
        cold = rack_diverse_cold(st, gs, agg, goal, tables, dims, 64)
        kind = torch.tensor(KIND_MOVE, dtype=torch.int32, device=rank.device)
        return (st, agg, tables, goal, gs, cp[:, :, None], kind, cs[:, :, None],
                cold[None, None, :].to(torch.int32))

    def disk_grid(st, agg):
        return drain_grid(disk_goal, st, agg)

    def soft_grid(st, agg):
        return drain_grid(by_name["CpuUsageDistributionGoal"], st, agg)

    def lead_grid(st, agg):
        tables = priors(cpu_goal, st, agg)
        gs = cpu_goal.prepare(st, agg, dims)
        return (st, agg, tables, cpu_goal, gs, *leadership_grid(agg.assignment))

    def k3_path(args):
        """The K3 path the wrapper takes for these arguments."""
        from cruise_control_torch.kernels import score_candidates as k3m

        _, shape3, strides = k3m.layout(*args[5:])
        return k3m.PATH_NAMES[k3m.choose_path(shape3, strides, args[1].assignment.shape[1])]

    k3_rows = []
    for label, make, grid_goal in (("move grid", disk_grid, disk_goal),
                                   ("promotion grid", lead_grid, cpu_goal),
                                   ("soft move grid", soft_grid,
                                    by_name["CpuUsageDistributionGoal"])):
        args_g, args_c = make(st_g, agg_g), make(st_c, agg_c)
        s_g = score_candidates(*args_g)
        s_c = score_candidates_plain(*args_c)
        torch.cuda.synchronize()
        s_g_c = s_g.cpu()
        if not torch.equal(torch.isfinite(s_g_c), torch.isfinite(s_c)):
            fail(f"K3 score_candidates ({label}): finite masks differ")
        fin = torch.isfinite(s_c)
        if not bits_equal(s_g_c[fin], s_c[fin]):
            fail(f"K3 score_candidates ({label}): scores differ")
        idx = args_c[5:]
        shape = s_c.shape
        parts = torch.unique(idx[0].expand(shape).reshape(-1)).numel()
        brokers = dims.num_brokers if label == "promotion grid" else min(
            dims.num_brokers, 512 + 64)
        if label == "soft move grid" and not bool(args_c[2].band_on.any()):
            fail("K3 score_candidates (soft move grid): the priors' usage bands are off")
        nbytes = (sum(t.numel() * 4 for t in idx if t.dim()) + s_c.numel() * 4
                  + parts * (r * 4 + 24 + 4 + 8) + brokers * 168)
        # ~100 operations per candidate (csrc/score_candidates.cu); the
        # kernel called with a context packed once, as a round calls it
        k3_rows.append(dict(label=label, err=max_abs_err(s_g_c, s_c),
                            call=lambda i, a=args_g, c=ScoreContext(*args_g[:5]):
                            score_candidates(*a, ctx=c),
                            plain=lambda i, a=args_g: score_candidates_plain(*a),
                            nbytes=nbytes, nops=100 * s_c.numel(), cells=s_c.numel(),
                            path=k3_path(args_g)))
        print(f"K3 score_candidates ({label}, {tuple(shape)}): {int(fin.sum())} finite of "
              f"{s_c.numel()}, masks exact")
    # K3's general path on a drain wave's 512-cell re-score (drain.py's first
    # wave under DiskCapacityGoal: each row's best candidate toward its
    # rotated destination column) and its promotion path (a thread a cell:
    # 49,152 cells are below the factored tiles' floor) on the grid round's
    # all-broker re-score (optimizer.py) of 16 entries, replicas on dead
    # brokers, against the bucketed context's 3,072 brokers
    grid_c = disk_grid(st_c, agg_c)
    s_grid = score_candidates_plain(*grid_c)
    v3, k3c, c3 = s_grid.shape
    rows3 = torch.arange(v3)
    ci3 = torch.argmax(s_grid[rows3, :, rows3 % c3], dim=1) * c3 + rows3 % c3

    def wave_cells(args):
        cp3, cs3, dst3 = args[5], args[7], args[8]
        d = cp3.device
        ci, r0 = ci3.to(d), rows3.to(d)
        return (*args[:5], cp3[r0, ci // c3, 0].contiguous(),
                torch.full((v3,), KIND_MOVE, dtype=torch.int32, device=d),
                cs3[r0, ci // c3, 0].contiguous(), dst3.reshape(-1)[ci % c3].contiguous())

    p10_c, st10_c_, dims10 = ctx10_c[1], ctx10_c[3], ctx10_c[2]
    on_dead10 = (p10_c.assignment >= 0) & st10_c_.dead[p10_c.assignment.clamp(min=0).long()]
    sel10 = torch.nonzero(on_dead10)[:16].to(torch.int32)

    def all_broker_cells(ctx10):
        pm, d10, s10 = ctx10[1], ctx10[2], ctx10[3]
        a10 = compute_aggregates(s10, pm.assignment, d10)
        d = pm.assignment.device
        sel = sel10.to(d)
        return (s10, a10, build_tables(goals[:goals.index(disk_goal)], s10, a10, d10), disk_goal,
                disk_goal.prepare(s10, a10, d10), sel[:, :1].contiguous(),
                torch.full((len(sel), 1), KIND_MOVE, dtype=torch.int32, device=d),
                sel[:, 1:].contiguous(),
                torch.arange(d10.num_brokers, dtype=torch.int32, device=d)[None, :])

    for label, args_g, args_c in (("wave re-score", wave_cells(disk_grid(st_g, agg_g)),
                                   wave_cells(grid_c)),
                                  ("all-broker re-score", all_broker_cells(ctx10_g),
                                   all_broker_cells(ctx10_c))):
        s_g = score_candidates(*args_g).cpu()
        s_c = score_candidates_plain(*args_c)
        fin = torch.isfinite(s_c)
        if not torch.equal(torch.isfinite(s_g), fin) or not bits_equal(s_g[fin], s_c[fin]):
            fail(f"K3 score_candidates ({label}): differs from the plain version")
        if not bool(fin.any()):
            fail(f"K3 score_candidates ({label}): no finite cell")
        idx = args_c[5:]
        parts = torch.unique(idx[0].expand(s_c.shape).reshape(-1)).numel()
        if label == "wave re-score":
            a_ = args_c[1].assignment
            brokers = torch.unique(torch.cat([a_[idx[0].long(), idx[2].long()], idx[3]])).numel()
        else:
            brokers = args_c[1].broker_load.shape[0]
        nbytes = (sum(t.numel() * 4 for t in idx if t.dim()) + s_c.numel() * 4
                  + parts * (r * 4 + 24 + 4 + 8) + brokers * 168)
        k3_rows.append(dict(label=label, err=max_abs_err(s_g, s_c),
                            call=lambda i, a=args_g, c=ScoreContext(*args_g[:5]):
                            score_candidates(*a, ctx=c),
                            plain=lambda i, a=args_g: score_candidates_plain(*a),
                            nbytes=nbytes, nops=100 * s_c.numel(), cells=s_c.numel(),
                            path=k3_path(args_g)))
        print(f"K3 score_candidates ({label}, {tuple(s_c.shape)}, the {k3_rows[-1]['path']} "
              f"path): {int(fin.sum())} finite of {s_c.numel()}, bit-equal to the plain version")
    del ctx10_g, ctx10_c

    # the JSON row carries the hard goal's move grid; the others are printed
    err3 = max(x["err"] for x in k3_rows)
    for x, key in zip(k3_rows, ("score_candidates", "score_candidates promotion grid",
                                "score_candidates soft move grid",
                                "score_candidates wave re-score",
                                "score_candidates all-broker re-score")):
        rw = row(key, "score_candidates.cu", "cruise_control_tpu/analyzer/acceptance.py:330",
                 err3, x["call"], x["plain"], x["nbytes"], x["nops"],
                 f"the {x['path']} path (source and destination halves, score_goal.cuh), "
                 f"{x['label']} of {x['cells']} cells")
        if key != "score_candidates":
            rows.pop(key)
            print(f"K3 score_candidates on the {x['label']} ({x['path']} path): "
                  f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, plain "
                  f"{rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms by {rw['bound_by']}")
    del k3_rows, x, args_g, args_c

    # K4 on a 1,024-entry wave: each move-grid row's best cell (512) and the
    # 512 best promotions of the CPU grid
    def wave(st, agg):
        a = disk_grid(st, agg)
        s = score_candidates_plain(*a) if agg.assignment.device.type == "cpu" else score_candidates(*a)
        v, k, c = s.shape
        cells = s.reshape(v, k * c)
        # a first wave's nominations: each row's best candidate toward its
        # own rotated destination column (drain.make_drain_round)
        rows0 = torch.arange(v, device=s.device)
        c_i = rows0 % c
        ci = torch.argmax(s[rows0, :, c_i], dim=1) * c + c_i
        cp, cs, dst = a[5][:, :, 0], a[7][:, :, 0], a[8].reshape(-1)
        l = lead_grid(st, agg)
        ls = score_candidates_plain(*l) if agg.assignment.device.type == "cpu" else score_candidates(*l)
        ls0, li = top_k(ls.reshape(-1), 1024 - v)
        lp = (li // (r - 1)).to(torch.int32)
        lslot = (li % (r - 1)).to(torch.int32) + 1
        ldst = agg.assignment[lp.long(), lslot.long()]
        p_ = torch.cat([cp[rows0, ci // c], lp])
        kind = torch.cat([torch.zeros(v, dtype=torch.int32, device=ci.device),
                          torch.ones(1024 - v, dtype=torch.int32, device=ci.device)])
        slot = torch.cat([cs[rows0, ci // c], lslot])
        d_ = torch.cat([dst[ci % c], ldst])
        score = torch.cat([cells[rows0, ci], ls0])
        return p_, kind, slot, d_, score, torch.isfinite(score)

    w_g, w_c = wave(st_g, agg_g), wave(st_c, agg_c)
    for n_, a_, b_ in zip(("p", "kind", "slot", "dst", "ok"), w_g[:4] + w_g[5:], w_c[:4] + w_c[5:]):
        if not bits_equal(a_, b_):
            fail(f"K4 inputs: {n_} differs between the card and the CPU")

    def clone(agg):
        return type(agg)(*(t.clone() for t in agg))

    a4_g, a4_c = clone(agg_g), clone(agg_c)
    sel_g = apply_wave(st_g, a4_g, *w_g[:4], w_c[4].to(dev), w_g[5], 7)
    sel_c = apply_wave_plain(st_c, a4_c, *w_c, 7)
    torch.cuda.synchronize()
    if not bits_equal(sel_g, sel_c):
        fail("K4 apply_wave: selection differs from the plain version")
    for n_, a_, b_ in zip(a4_c._fields, a4_g, a4_c):
        if not bits_equal(a_, b_):
            fail(f"K4 apply_wave: applied {n_} differs from the plain version")
    n_sel = int(sel_c.sum())
    k4_err = max([max_abs_err(sel_g, sel_c)] + [max_abs_err(a_, b_) for a_, b_ in zip(a4_g, a4_c)])
    score_g = w_c[4].to(dev)
    # each call applies the wave to a fresh copy of the aggregates: a pool of
    # copies is made before each timed run, outside it
    pool = []

    def k4_call(fn):
        def call(i):
            if i == 0:
                pool[:] = [clone(agg_g) for _ in range(WARMUP + REPS)]
                torch.cuda.synchronize()
            return fn(st_g, pool[i], *w_g[:4], score_g, w_g[5], 7)
        return call

    k4_bytes = 1024 * (4 * 4 + 4 + 1 + 1) + 1024 * (r * 4 * 2 + 24) + n_sel * (2 * r * 4 * 2 + 2 * 56)
    # per entry: the four selection stages' scatter-max / scatter-min and
    # group claims, and its share of the applies
    k4_drain = row("apply_wave drain wave", "apply_wave.cu",
                   "cruise_control_tpu/analyzer/context.py:425", k4_err, k4_call(apply_wave),
                   k4_call(apply_wave_plain), k4_bytes, 1024 * 60,
                   "one block of 1,024 threads: O(N) stages over per-group tables")
    rows.pop("apply_wave drain wave")
    pool.clear()
    print(f"K4 apply_wave: 1,024-entry drain wave, {n_sel} selected, selection and every "
          f"aggregate bit-equal; {k4_drain['ms']:.4f} ms on the device, "
          f"{k4_drain['call_ms']:.4f} ms per call, plain {k4_drain['plain_ms']:.4f} ms, bound "
          f"{k4_drain['bound_ms']:.6f} ms")

    # K4 on a 2,600-entry two-leg wave in the relay form
    n4 = K4_RELAY_ENTRIES
    relay_c = k4_relay_wave(model_cpu.assignment.numpy(), dims.num_brokers)
    relay_g = [t.to(dev) for t in relay_c]

    a4_g, a4_c = clone(agg_g), clone(agg_c)
    sel_g = k4_relay_apply(apply_wave, st_g, a4_g, relay_g)
    sel_c = k4_relay_apply(apply_wave_plain, st_c, a4_c, relay_c)
    torch.cuda.synchronize()
    if not bits_equal(sel_g, sel_c):
        fail("K4 apply_wave (two-leg): selection differs from the plain version")
    for n_, a_, b_ in zip(a4_c._fields, a4_g, a4_c):
        if not bits_equal(a_, b_):
            fail(f"K4 apply_wave (two-leg): applied {n_} differs from the plain version")
    n_sel = int(sel_c.sum())
    k4_err = max([max_abs_err(sel_g, sel_c)] + [max_abs_err(a_, b_) for a_, b_ in zip(a4_g, a4_c)])

    def k4_relay_call(fn):
        def call(i):
            if i == 0:
                pool[:] = [clone(agg_g) for _ in range(WARMUP + REPS)]
                torch.cuda.synchronize()
            return k4_relay_apply(fn, st_g, pool[i], relay_g)
        return call

    # entries: 8 index words, a score and two flags; per selected entry both
    # legs' rows and the aggregate words of three brokers and two hosts
    k4_bytes = n4 * (8 * 4 + 4 + 1 + 1) + n4 * 2 * (r * 4 + 24) + n_sel * 2 * (
        2 * r * 4 * 2 + 2 * 56)
    row("apply_wave", "apply_wave.cu", "cruise_control_tpu/analyzer/context.py:425", k4_err,
        k4_relay_call(apply_wave), k4_relay_call(apply_wave_plain), k4_bytes, n4 * 90,
        "2,600-entry two-leg relay wave: one block of 1,024 threads, each owning up to four "
        "entries, O(N) stages of shared-memory atomics over per-group tables (the partitions' "
        "in a global workspace), the host-CPU updates host by host; latency, not bytes or "
        "operations, sets its time")
    pool.clear()
    print(f"K4 apply_wave: 2,600-entry two-leg relay wave, {n_sel} selected, selection and every "
          f"aggregate bit-equal")
    del a4_g, a4_c

    # K4 on the bulk planner's wave: one entry per broker of the smoke
    # model's bucketed service context (3,072)
    st_b_g, agg_b_g, bulk_g = k4_bulk_wave(model_cpu, "cuda")
    _, pm_b_c, dims_b, st_b_c, _, _ = opt.GoalOptimizer(
        device="cpu", settings=opt.SERVICE_SETTINGS)._build_ctx(model_cpu)
    agg_b_c = compute_aggregates(st_b_c, pm_b_c.assignment, dims_b)
    bulk_c = tuple(a.cpu() if torch.is_tensor(a) else a for a in bulk_g)
    nb = bulk_g[0].shape[0]
    a4_g, a4_c = clone(agg_b_g), clone(agg_b_c)
    sel_g = apply_wave(st_b_g, a4_g, *bulk_g)
    sel_c = apply_wave_plain(st_b_c, a4_c, *bulk_c)
    torch.cuda.synchronize()
    if not bits_equal(sel_g, sel_c):
        fail("K4 apply_wave (bulk wave): selection differs from the plain version")
    for n_, a_, b_ in zip(a4_c._fields, a4_g, a4_c):
        if not bits_equal(a_, b_):
            fail(f"K4 apply_wave (bulk wave): applied {n_} differs from the plain version")
    n_sel, n_ok = int(sel_c.sum()), int(bulk_c[5].sum())
    if n_sel == 0:
        fail("K4 apply_wave (bulk wave): the wave selected nothing")
    k4_err = max([max_abs_err(sel_g, sel_c)] + [max_abs_err(a_, b_) for a_, b_ in zip(a4_g, a4_c)])

    def k4_bulk_call(fn):
        def call(i):
            if i == 0:
                pool[:] = [clone(agg_b_g) for _ in range(WARMUP + REPS)]
                torch.cuda.synchronize()
            return fn(st_b_g, pool[i], *bulk_g)
        return call

    k4_bytes = nb * (4 * 4 + 4 + 1 + 1) + nb * (r * 4 * 2 + 24) + n_sel * (2 * r * 4 * 2 + 2 * 56)
    k4_bulk = row("apply_wave bulk wave", "apply_wave.cu",
                  "cruise_control_tpu/analyzer/context.py:425", k4_err, k4_bulk_call(apply_wave),
                  k4_bulk_call(apply_wave_plain), k4_bytes, nb * 60,
                  f"the bulk planner's {nb}-entry wave, one leg")
    rows.pop("apply_wave bulk wave")
    pool.clear()
    print(f"K4 apply_wave: the bulk planner's {nb}-entry wave (ReplicaDistributionGoal, "
          f"{dims_b.num_brokers} brokers, {n_ok} flagged), {n_sel} selected, selection and every "
          f"aggregate bit-equal; {k4_bulk['ms']:.4f} ms on the device, {k4_bulk['call_ms']:.4f} "
          f"ms per call, plain {k4_bulk['plain_ms']:.4f} ms, bound {k4_bulk['bound_ms']:.6f} ms")
    del a4_g, a4_c

    # K4's wide configuration: the bulk planner's wave on WIDE_CLUSTER's
    # 5,000 brokers, bucketed to 5,120 (past the block configuration's 4,096
    # entries)
    model_w = generators.random_cluster(SEED, generators.ClusterProperty(**WIDE_CLUSTER))
    st_w_g, agg_w_g, wide_g = k4_bulk_wave(model_w, "cuda")
    _, pm_w_c, dims_w, st_w_c, _, _ = opt.GoalOptimizer(
        device="cpu", settings=opt.SERVICE_SETTINGS)._build_ctx(model_w)
    agg_w_c = compute_aggregates(st_w_c, pm_w_c.assignment, dims_w)
    wide_c = tuple(a.cpu() if torch.is_tensor(a) else a for a in wide_g)
    nw = wide_g[0].shape[0]
    if nw <= 4096:
        fail(f"K4 apply_wave (wide wave): {nw} entries, not past the block configuration")
    a4_g, a4_c = clone(agg_w_g), clone(agg_w_c)
    sel_g = apply_wave(st_w_g, a4_g, *wide_g)
    sel_c = apply_wave_plain(st_w_c, a4_c, *wide_c)
    torch.cuda.synchronize()
    if not bits_equal(sel_g, sel_c):
        fail("K4 apply_wave (wide wave): selection differs from the plain version")
    for n_, a_, b_ in zip(a4_c._fields, a4_g, a4_c):
        if not bits_equal(a_, b_):
            fail(f"K4 apply_wave (wide wave): applied {n_} differs from the plain version")
    n_sel = int(sel_c.sum())
    if n_sel == 0:
        fail("K4 apply_wave (wide wave): the wave selected nothing")
    k4_err = max([max_abs_err(sel_g, sel_c)] + [max_abs_err(a_, b_) for a_, b_ in zip(a4_g, a4_c)])

    def k4_wide_call(fn):
        def call(i):
            if i == 0:
                pool[:] = [clone(agg_w_g) for _ in range(WARMUP + REPS)]
                torch.cuda.synchronize()
            return fn(st_w_g, pool[i], *wide_g)
        return call

    k4_bytes = nw * (4 * 4 + 4 + 1 + 1) + nw * (r * 4 * 2 + 24) + n_sel * (2 * r * 4 * 2 + 2 * 56)
    k4_wide = row("apply_wave wide wave", "apply_wave.cu",
                  "cruise_control_tpu/analyzer/context.py:425", k4_err, k4_wide_call(apply_wave),
                  k4_wide_call(apply_wave_plain), k4_bytes, nw * 60,
                  f"the bulk planner's {nw}-entry wave on {dims_w.num_brokers} brokers, one leg: "
                  "the wide configuration")
    rows.pop("apply_wave wide wave")
    pool.clear()
    print(f"K4 apply_wave: the bulk planner's {nw}-entry wave on {dims_w.num_brokers} brokers "
          f"(the wide configuration), {n_sel} selected, selection and every aggregate "
          f"bit-equal; {k4_wide['ms']:.4f} ms on the device, {k4_wide['call_ms']:.4f} ms per "
          f"call, plain {k4_wide['plain_ms']:.4f} ms, bound {k4_wide['bound_ms']:.6f} ms")
    del a4_g, a4_c, model_w, st_w_g, agg_w_g, st_w_c, agg_w_c, pm_w_c

    # K5 on DiskUsageDistributionGoal's [128, 128, 8, 8] replica-swap grid
    # (the staged path), TopicReplicaDistributionGoal's [512, 16, 8]
    # topic-swap grid and LeaderBytesInDistributionGoal's [512, 4, 2, 8, 2]
    # relay grid (a thread a cell), each under its priors' tables, and a
    # wave's re-validation of 128 nominated swaps; each called with its
    # round's context, as the rounds call it
    disk_use, lbi = by_name["DiskUsageDistributionGoal"], by_name["LeaderBytesInDistributionGoal"]
    topic_goal = by_name["TopicReplicaDistributionGoal"]

    def swap_args(st, agg):
        gs = disk_use.prepare(st, agg, dims)
        grid = swap_grid(st, agg, disk_use.resource, disk_use.drain_contrib(st, gs, agg).contiguous(),
                         128, 8, dims.num_brokers)[-1]
        return (REPLICA_SWAP, st, agg, priors(disk_use, st, agg), gs, *grid)

    def swap_wave_args(st, agg):
        gs = disk_use.prepare(st, agg, dims)
        hot, cold, hp, hs, cp, cs, _ = swap_grid(
            st, agg, disk_use.resource, disk_use.drain_contrib(st, gs, agg).contiguous(), 128, 8,
            dims.num_brokers)
        return (REPLICA_SWAP, st, agg, priors(disk_use, st, agg), gs, hp[:, 0].contiguous(),
                hs[:, 0].contiguous(), hot, cp[:, 0].contiguous(), cs[:, 0].contiguous(), cold)

    def topic_swap_args(st, agg):
        gs = topic_goal.prepare(st, agg, dims)
        tables = priors(topic_goal, st, agg)
        grid = topic_swap_grid(st, agg, tables, gs, 0, 512, 16, 8, dims.num_topics,
                               dims.num_brokers)[-1]
        return (TOPIC_SWAP, st, agg, tables, gs, *grid)

    def relay_args(st, agg):
        gs = lbi.prepare(st, agg, dims)
        grid = relay_grid(st, agg, gs, lbi, 0, 512, 4, 8, dims.num_brokers)[-1]
        return (LEADERSHIP_RELAY, st, agg, priors(lbi, st, agg), gs, *grid)

    k5_rows = []
    for label, make, kw in (("replica-swap grid", swap_args, dict(resource=disk_use.resource)),
                            ("replica-swap wave", swap_wave_args,
                             dict(resource=disk_use.resource, wave=True)),
                            ("topic-swap grid", topic_swap_args, {}),
                            ("relay grid", relay_args, {})):
        args_g, args_c = make(st_g, agg_g), make(st_c, agg_c)
        for i_, (x_, y_) in enumerate(zip(args_g[5:], args_c[5:])):
            if not bits_equal(x_, y_):
                fail(f"K5 score_swaps ({label}): index tensor {i_} differs between card and CPU")
        before = dict(score_swaps.paths)
        o_g = score_swaps(*args_g, **kw)
        torch.cuda.synchronize()
        path = [k for k, v in score_swaps.paths.items() if v != before.get(k, 0)]
        o_c = score_swaps_plain(*args_c, **kw)
        o_g_c = o_g.cpu()
        fin = torch.isfinite(o_c)
        if not torch.equal(fin, torch.isfinite(o_g_c)) or not bits_equal(o_g_c[fin], o_c[fin]):
            fail(f"K5 score_swaps ({label}): differs from the plain version")
        if path != (["staged"] if label == "replica-swap grid" else ["cells"]):
            fail(f"K5 score_swaps ({label}): took the path {path}")
        cells = o_c.numel()
        # distinct inputs: the index tensors, each picked partition's rows
        # (assignment, load, rack counts) and each broker's aggregate and
        # table words; the output once
        idx_bytes = sum(t.numel() * 4 for t in args_c[5:])
        parts = torch.unique(torch.cat([args_c[5].reshape(-1), args_c[8].reshape(-1)])).numel()
        brokers = torch.unique(torch.cat([args_c[7].reshape(-1), args_c[10].reshape(-1)])).numel()
        nbytes = idx_bytes + cells * 4 + parts * (r * 4 + 24 + dims.num_racks * 4 + 4) + brokers * 200
        ctx5 = swap_context(None, *args_g[1:5])
        k5_rows.append(dict(label=label, err=max_abs_err(o_g_c, o_c), cells=cells,
                            finite=int(fin.sum()), nbytes=nbytes, path=path[0],
                            call=lambda i, a=args_g, k=kw, c=ctx5: score_swaps(*a, **k, ctx=c),
                            plain=lambda i, a=args_g, k=kw: score_swaps_plain(*a, **k)))
        print(f"K5 score_swaps ({label}, {tuple(o_c.shape)}, the {path[0]} path): "
              f"{int(fin.sum())} finite of {cells}, masks and improvements bit-equal")
    err5 = max(x["err"] for x in k5_rows)
    for x in k5_rows:
        key = "score_swaps" if x["label"] == "replica-swap grid" else "score_swaps " + x["label"]
        # ~200 operations per cell (csrc/score_swaps.cu)
        rw = row(key, "score_swaps.cu", "cruise_control_tpu/analyzer/swaps.py:98", err5, x["call"],
                 x["plain"], x["nbytes"], 200 * x["cells"],
                 f"the {x['path']} path, {x['label']} of {x['cells']} cells, a round's context")
        if key != "score_swaps":
            rows.pop(key)
            print(f"K5 score_swaps on the {x['label']} ({x['path']} path): {rw['ms']:.4f} ms on "
                  f"the device, {rw['call_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, "
                  f"bound {rw['bound_ms']:.6f} ms by {rw['bound_by']}")

    # K6 on TopicReplicaDistributionGoal's first-round 512 surplus pairs, at
    # the pair drain's k = 4 (the JSON row) and at k = 8
    def pairs(st, agg, k):
        gs = topic_goal.prepare(st, agg, dims)
        pt, pb, _ = select_surplus_pairs(st, agg, priors(topic_goal, st, agg), gs, 0, 512,
                                         dims.num_topics, dims.num_brokers)
        return (agg.assignment, st.topic_id, st.movable_partition, pt, pb, k, dims.num_brokers)

    for k6 in (4, 8):
        k6_g, k6_c = pairs(st_g, agg_g, k6), pairs(st_c, agg_c, k6)
        for i_ in (3, 4):
            if not bits_equal(k6_g[i_], k6_c[i_]):
                fail("K6 pair_picks: the surplus pairs differ between card and CPU")
        o6_g = pair_picks(*k6_g)
        torch.cuda.synchronize()
        o6_c = pair_picks_plain(*k6_c)
        for n_, a_, b_ in zip(("p", "slot", "found"), o6_g, o6_c):
            if not bits_equal(a_, b_):
                fail(f"K6 pair_picks (k = {k6}): {n_} differs from the plain version")
        # one pass: the assignment, each slot's topic and movable flag, each
        # broker's pair row; the [512, k] outputs once
        key = "pair_picks" if k6 == 4 else f"pair_picks k = {k6}"
        rw = row(key, "pair_picks.cu", "cruise_control_tpu/analyzer/drain.py:235",
                 max(max_abs_err(a_, b_) for a_, b_ in zip(o6_g, o6_c)),
                 lambda i, a=k6_g: pair_picks(*a), lambda i, a=k6_g: pair_picks_plain(*a),
                 p_count * r * 4 + p_count * 5 + dims.num_brokers * 4 + 512 * 8 + 512 * k6 * 9,
                 p_count * r * 6 + int(o6_c[2].sum()) * k6,
                 f"k = {k6}: two launches, one pass over the slots (the pair rows in each "
                 "block's shared memory, each slot inserting into its row's k-entry list by an "
                 "atomicMin cascade), then the picks' write-out")
        if key != "pair_picks":
            rows.pop(key)
        print(f"K6 pair_picks: 512 pairs x {k6}, {int(o6_c[2].sum())} found, exact; "
              f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, plain "
              f"{rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms")

    # window_sum in XLA:CPU's order on the brokers' leader bytes-in
    # (LeaderBytesInDistributionGoal's window, the JSON row), the [2,600, 4]
    # broker loads (the mean replica load) and the 199,518 partitions' leader
    # bytes-in (the goal's bulk unit)
    ws_inputs = (("leader bytes-in", agg_g.leader_nw_in, agg_c.leader_nw_in),
                 ("broker loads", agg_g.broker_load, agg_c.broker_load),
                 ("partition leader bytes-in", st_g.part_load[:, 2].contiguous(),
                  st_c.part_load[:, 2].contiguous()))
    def ws_row(label, x_g, x_c):
        """Hold window_sum on x_g to its plain version on x_c, time it beside
        torch.sum and the previous design, and return its row."""
        ws_g = window_sum(x_g)
        torch.cuda.synchronize()
        ws_c = window_sum_plain(x_c)
        if not bits_equal(ws_g, ws_c):
            fail(f"window_sum ({label}, {tuple(x_c.shape)}) differs from the plain version")
        n_terms = x_c.numel()
        rw = row("window_sum " + label, "window_sum.cu",
                 "cruise_control_tpu/analyzer/goals/soft.py:462", max_abs_err(ws_g, ws_c),
                 lambda i: window_sum(x_g), lambda i: window_sum_plain(x_g),
                 n_terms * 4 + ws_c.numel() * 4, n_terms,
                 f"{tuple(x_c.shape)}: one launch, level 1 over blocks of 256 (window, column) "
                 "pairs staged in shared memory, the last block of a column tile runs the "
                 "later levels", library=lambda i: torch.sum(x_g, dim=0))
        rows.pop("window_sum " + label)
        print(f"window_sum ({label}, {tuple(x_c.shape)}): bit-equal to the plain version; "
              f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, torch.sum "
              f"{rw['library_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, bound "
              f"{rw['bound_ms']:.6f} ms; {previous(label)}")
        return rw

    ws_rows = [ws_row(*args) for args in ws_inputs]
    rows["window_sum"] = dict(ws_rows[0], name="window_sum")

    # on the smoke model's bucketed service context (3,072 brokers, the
    # last 472 empty): window_sum on the brokers' leader bytes-in, and K2 on
    # the bulk planner's drain priorities (ReplicaDistributionGoal's, 1e9 on
    # the dead brokers' replicas, bulk.py) with its k
    ws_row("bucketed leader bytes-in", agg_b_g.leader_nw_in, agg_b_c.leader_nw_in)
    rep_goal = by_name["ReplicaDistributionGoal"]

    def bulk_contrib(st, agg):
        gs = rep_goal.prepare(st, agg, dims_b)
        c = rep_goal.drain_contrib(st, gs, agg)
        return torch.where(replicas_on_dead(st, agg.assignment),
                           torch.tensor(1e9, dtype=torch.float32, device=c.device), c).contiguous()

    k2_row("bulk planner, bucketed", "broker_topk bulk", bulk_contrib(st_b_g, agg_b_g),
           bulk_contrib(st_b_c, agg_b_c), agg_b_g.assignment, agg_b_c.assignment,
           st_b_g.movable_partition, st_b_c.movable_partition,
           opt.SERVICE_SETTINGS.drain_per_broker, dims_b.num_brokers, True)
    rows.pop("broker_topk bulk")

    def k7_row(label, key, ag, ac, nb):
        """K7 on `ag` against its plain version on `ac`, timed: 7 * B words
        read, an 8-byte word written, four operations a word (the weight's
        multiply-add and or, the product's multiply-add)."""
        fp_g = state_fingerprint(ag)
        torch.cuda.synchronize()
        fp_c = state_fingerprint_plain(ac)
        if int(fp_g) != int(fp_c):
            fail(f"K7 state_fingerprint ({label}): {int(fp_g)} differs from the plain version's "
                 f"{int(fp_c)}")
        rw = row(key, "state_fingerprint.cu", "cruise_control_tpu/analyzer/optimizer.py:1199",
                 abs(int(fp_g) - int(fp_c)), lambda i: state_fingerprint(ag),
                 lambda i: state_fingerprint_plain(ag), 7 * nb * 4 + 8, 7 * nb * 4,
                 f"{label}: one launch, 16-byte vector loads issued before any multiply, a "
                 "shuffle reduction a warp, one shared word a warp")
        print(f"K7 state_fingerprint ({label}): {int(fp_g)}, equal to the plain version; "
              f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, plain "
              f"{rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.7f} ms; {previous('K7 ' + label)}")

    # K7 on the bucketed service context's aggregates (3,072 brokers, the
    # main path's shape: the row) and on the smoke model's 2,600
    k7_row("bucketed", "state_fingerprint", agg_b_g, agg_b_c, dims_b.num_brokers)
    k7_row("smoke model", "state_fingerprint smoke", agg_g, agg_c, dims.num_brokers)
    rows.pop("state_fingerprint smoke")
    del agg_b_g, agg_b_c, st_b_g, st_b_c, pm_b_c

    # K8 on the smoke model's statistics (stats_before's inputs)
    from cruise_control_torch.models.flat_model import alive_broker_mask

    k8_g = (agg_g.broker_load, model.broker_capacity, alive_broker_mask(model), agg_g.replica_count,
            agg_g.leader_count, agg_g.potential_nw_out, agg_g.topic_replica_count)
    k8_c = (agg_c.broker_load, model_cpu.broker_capacity, alive_broker_mask(model_cpu),
            agg_c.replica_count, agg_c.leader_count, agg_c.potential_nw_out,
            agg_c.topic_replica_count)
    t_count, b_count = dims.num_topics, dims.num_brokers

    def k8_row(label, key, args_g, args_c):
        o8_g = cluster_stats(*args_g)
        torch.cuda.synchronize()
        o8_c = cluster_stats_plain(*args_c)
        for n_, a_, b_ in zip(("f32 fields", "counts"), o8_g, o8_c):
            if not bits_equal(a_, b_):
                fail(f"K8 cluster_stats ({label}): {n_} differ from the plain version")
        t_ = args_c[6].shape[0]
        # the [T, B] table once, the per-broker vectors once, the outputs; per
        # topic cell a subtract, a multiply, an add and the integer sums, per
        # broker and series about ten operations
        rw = row(key, "cluster_stats.cu", "cruise_control_tpu/analyzer/stats.py:69",
                 max(max_abs_err(a_, b_) for a_, b_ in zip(o8_g, o8_c)),
                 lambda i: cluster_stats(*args_g), lambda i: cluster_stats_plain(*args_g),
                 t_ * b_count * 4 + b_count * (16 + 16 + 1 + 4 + 4 + 4) + 25 * 4 + 12,
                 t_ * b_count * 6 + b_count * 7 * 10,
                 f"{label}: one launch, a block per per-broker series and a warp per topic "
                 "(XLA-ordered sums, a level-2 window a warp), the topic mean in the last "
                 "block")
        print(f"K8 cluster_stats ({label}): every field bit-equal to the plain version; "
              f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, plain "
              f"{rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms; "
              f"{previous('K8 ' + label)}")

    k8_row(f"{t_count} topics", "cluster_stats", k8_g, k8_c)
    # 20 topics: the mean over them in TOPIC_LANES' vectorized order
    k8_row("20 topics", "cluster_stats 20 topics",
           k8_g[:6] + (k8_g[6][:20].contiguous(),), k8_c[:6] + (k8_c[6][:20].contiguous(),))
    rows.pop("cluster_stats 20 topics")

    # K9 on the greedy round's grid of the smoke state: [199,518, 3, 16]
    # moves toward num_dst_candidates = 16 rack-representative brokers and
    # [199,518, 2] promotions, under DiskCapacityGoal (dead brokers: finite
    # evacuation scores) and LeaderReplicaDistributionGoal (promotions
    # compete), each under its priors' tables
    k_dst = opt.GREEDY_SETTINGS.num_dst_candidates

    def grid_args(goal, st, agg):
        tables = priors(goal, st, agg)
        gs = goal.prepare(st, agg, dims)
        cands = opt.dst_candidates(st, gs, agg, goal, dims, k_dst, tables)
        return st, agg, tables, goal, gs, cands

    def k3_argmax(st, agg, tables, goal, gs, cands):
        """The unfused comparison: K3 on the materialized move grid, then
        torch.argmax per partition and over the partitions."""
        s_ = score_candidates(st, agg, tables, goal, gs, *make_move_batch(agg.assignment, cands))
        best = torch.amax(s_.reshape(p_count, -1), dim=1)
        return torch.argmax(s_.reshape(p_count, -1), dim=1), torch.argmax(best)

    k9_rows = []
    for label, goal in (("hard goal", disk_goal),
                        ("leader count goal", by_name["LeaderReplicaDistributionGoal"])):
        args_g, args_c = grid_args(goal, st_g, agg_g), grid_args(goal, st_c, agg_c)
        if not bits_equal(args_g[5], args_c[5]):
            fail(f"K9 grid_shortlist ({label}): the destination candidates differ between card "
                 "and CPU")
        o9_g = grid_shortlist(*args_g)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        o9_c = grid_shortlist_plain(*args_c)
        plain_cpu_s = time.monotonic() - t0
        for n_, a_, b_ in zip(("score", "p", "kind", "slot", "dst"), o9_g, o9_c):
            if not bits_equal(a_, b_):
                fail(f"K9 grid_shortlist ({label}): {n_} differs from the plain version "
                     f"({a_.tolist()} vs {b_.tolist()})")
        if not bool(torch.isfinite(o9_c[0]).all()):
            fail(f"K9 grid_shortlist ({label}): no finite cell in the grid")
        kk = args_c[5].shape[0]
        cells = p_count * r * kk + (p_count * (r - 1) if goal.uses_leadership else 0)
        # each partition's row, its topic, its flag, the rack and topic-count
        # words of its source and destination racks and brokers, once; each
        # broker's aggregate and table words once; the outputs
        nbytes = p_count * (r * 4 + 24 + 4 + 1 + 2 * (kk + r) * 4) + dims.num_brokers * 168 + 20
        # ~100 operations per cell (csrc/score_goal.cuh)
        k9_rows.append(dict(label=label, cells=cells, nbytes=nbytes, nops=100 * cells,
                            err=max(max_abs_err(a_, b_) for a_, b_ in zip(o9_g, o9_c)),
                            call=lambda i, a=args_g, c=ScoreContext(*args_g[:5]):
                            grid_shortlist(*a, ctx=c),
                            plain=lambda i, a=args_g: grid_shortlist_plain(*a),
                            unfused=lambda i, a=args_g: k3_argmax(*a)))
        print(f"K9 grid_shortlist ({label}, [{p_count}, {r}, {kk}] moves"
              f"{f' + [{p_count}, {r - 1}] promotions' if goal.uses_leadership else ''}): "
              f"p {int(o9_c[1])} kind {int(o9_c[2])} slot {int(o9_c[3])} dst {int(o9_c[4])} score "
              f"{float(o9_c[0]):.6g}, bit-equal to the plain version (plain on the CPU "
              f"{plain_cpu_s:.1f} s)")
    err9 = max(x["err"] for x in k9_rows)
    for x, key in zip(k9_rows, ("grid_shortlist", "grid_shortlist leader count goal")):
        rw = row(key, "grid_shortlist.cu", "cruise_control_tpu/analyzer/optimizer.py:357", err9,
                 x["call"], x["plain"], x["nbytes"], x["nops"],
                 f"a warp per group of partitions, {x['cells'] // p_count} cells each (K3's "
                 "source and destination halves, staged at once), one record per block, a "
                 f"second launch takes the best; the {x['label']} grid of {x['cells']} cells")
        rw["k3_argmax_ms"] = time_ms(x["unfused"])
        print(f"K9 grid_shortlist on the {x['label']} grid: {rw['ms']:.4f} ms on the device, "
              f"{rw['call_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, K3 + argmax "
              f"{rw['k3_argmax_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms by {rw['bound_by']}")
        if key != "grid_shortlist":
            rows.pop(key)
    # K3 and K9 with goal case 15 (KafkaAssignerEvenRackAwareGoal, its
    # [512, 8, 64] drain grid and its greedy grid) and with the
    # only_move_immigrants flag set (the hard goal's grids), each bit-equal to
    # its plain version on the smoke model's state, and timed
    ka_even = ka_goals[0]
    imm_g = st_g._replace(only_move_immigrants=torch.tensor(True, device=dev))
    imm_c = st_c._replace(only_move_immigrants=torch.tensor(True))
    for kname, label, make, sg, sc in (
            ("K3", "case 15", lambda st, agg: drain_grid(ka_even, st, agg), st_g, st_c),
            ("K3", "immigrant flag", lambda st, agg: drain_grid(disk_goal, st, agg), imm_g, imm_c),
            ("K9", "case 15", lambda st, agg: grid_args(ka_even, st, agg), st_g, st_c),
            ("K9", "immigrant flag", lambda st, agg: grid_args(disk_goal, st, agg), imm_g,
             imm_c)):
        args_g, args_c = make(sg, agg_g), make(sc, agg_c)
        if kname == "K3":
            fn, plain_fn, key = score_candidates, score_candidates_plain, "score_candidates"
            out_g, out_c = fn(*args_g).cpu(), plain_fn(*args_c)
            fin = torch.isfinite(out_c)
            if not torch.equal(torch.isfinite(out_g), fin) or not bits_equal(out_g[fin], out_c[fin]):
                fail(f"K3 score_candidates ({label}): differs from the plain version")
            idx = args_c[5:]
            parts = torch.unique(idx[0].expand(out_c.shape).reshape(-1)).numel()
            nbytes = (sum(t.numel() * 4 for t in idx if t.dim()) + out_c.numel() * 4
                      + parts * (r * 4 + 24 + 4 + 8) + min(dims.num_brokers, 512 + 64) * 168)
            cells, err = out_c.numel(), max_abs_err(out_g, out_c)
            what = f"{int(fin.sum())} finite of {cells}"
            src = "score_candidates.cu"
            replaces = "cruise_control_tpu/analyzer/acceptance.py:330"
        else:
            fn, plain_fn, key = grid_shortlist, grid_shortlist_plain, "grid_shortlist"
            out_g, out_c = fn(*args_g), plain_fn(*args_c)
            for n_, a_, b_ in zip(("score", "p", "kind", "slot", "dst"), out_g, out_c):
                if not bits_equal(a_, b_):
                    fail(f"K9 grid_shortlist ({label}): {n_} differs from the plain version")
            kk = args_c[5].shape[0]
            cells = p_count * r * kk
            nbytes = (p_count * (r * 4 + 24 + 4 + 1 + 2 * (kk + r) * 4) + dims.num_brokers * 168
                      + 20)
            err = max(max_abs_err(a_, b_) for a_, b_ in zip(out_g, out_c))
            what = (f"p {int(out_c[1])} kind {int(out_c[2])} slot {int(out_c[3])} score "
                    f"{float(out_c[0]):.6g}")
            src = "grid_shortlist.cu"
            replaces = "cruise_control_tpu/analyzer/optimizer.py:357"
        if kname == "K3" and label == "immigrant flag":
            p_, sl_ = (t.expand(out_c.shape).long() for t in (args_c[5], args_c[7]))
            if not bool(sc.dead[agg_c.assignment[p_, sl_][fin].long()].all()):
                fail("K3 score_candidates (immigrant flag): a finite cell's source is alive")
        rw = row(f"{key} {label}", src, replaces, err,
                 lambda i, a=args_g, f=fn, c=ScoreContext(*args_g[:5]): f(*a, ctx=c),
                 lambda i, a=args_g, f=plain_fn: f(*a), nbytes, 100 * cells,
                 f"{kname} with {label}, {cells} cells")
        rows.pop(f"{key} {label}")
        print(f"{kname} {key} with {label}: {what}, bit-equal to the plain version; "
              f"{rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per call, plain "
              f"{rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms by {rw['bound_by']}")
    del agg_g, agg_c

    # K11 on the demote phase's model: the smoke model with 26 brokers demoted
    # (option_recipes), its 26 dead brokers, every partition's row
    demote_fields = option_recipes({k: v.numpy() for k, v in model_cpu._asdict().items()})[
        "demote"][0]
    m11_c = from_numpy(demote_fields)
    m11_g = m11_c.to(dev)
    st11_c, st11_g = build_static_ctx(m11_c, constraint, dims), build_static_ctx(m11_g, constraint,
                                                                                dims)
    o11_g = elect_preferred(m11_g.assignment, st11_g.demoted, st11_g.dead)
    torch.cuda.synchronize()
    o11_c = elect_preferred_plain(m11_c.assignment, st11_c.demoted, st11_c.dead)
    if not bits_equal(o11_g, o11_c):
        fail("K11 elect_preferred: differs from the plain version")
    if not torch.equal(m11_g.assignment.cpu(), m11_c.assignment):
        fail("K11 elect_preferred: the input assignment changed")
    moved11 = int((o11_c[:, 0] != m11_c.assignment[:, 0]).sum())
    # the assignment read once and written once, the two masks; per slot a
    # few compares and selects
    r11 = row("elect_preferred", "elect_preferred.cu",
              "cruise_control_tpu/analyzer/goals/preferred.py:22", max_abs_err(o11_g, o11_c),
              lambda i: elect_preferred(m11_g.assignment, st11_g.demoted, st11_g.dead),
              lambda i: elect_preferred_plain(m11_g.assignment, st11_g.demoted, st11_g.dead),
              2 * p_count * r * 4 + 2 * dims.num_brokers, 4 * p_count * r,
              f"tiles of 512 rows staged flat in 16-byte vectors, the flags merged into a "
              f"byte a broker in shared memory, a fresh [{p_count}, {r}] output; "
              f"{moved11} leaders moved")
    print(f"K11 elect_preferred: {moved11} of {p_count} leaders moved off demoted or dead "
          f"brokers, bit-equal to the plain version, the input unchanged; {r11['ms']:.4f} ms "
          f"on the device, {r11['call_ms']:.4f} ms per call, {previous('K11 smoke model')}")
    del m11_g, st11_g, o11_g

    # -- 4.-7. the solves -------------------------------------------------------
    from cruise_control_torch.analyzer.stats import stats_to_dict

    kernel_rows_s = time.monotonic() - t_start
    print(f"kernel rows: {kernel_rows_s:.1f} s from the start, the build included")

    # the bench's config-5 model (bench.py:642) and its parity model
    # (bench.py:596-604)
    t0 = time.monotonic()
    bench_model = generators.random_cluster(SEED, generators.BASELINE_CONFIGS[5])
    parity_model = generators.random_cluster(SEED + 5, generators.ClusterProperty(
        num_racks=52, num_brokers=PARITY_BROKERS, num_topics=max(50, (PARITY_BROKERS * 20) // 13),
        mean_partitions_per_topic=50.0, replication_factor=3, load_distribution="exponential"))
    print(f"bench model: {bench_model.num_brokers} brokers, {bench_model.num_partitions} "
          f"partitions; parity model: {parity_model.num_brokers} brokers, "
          f"{parity_model.num_partitions} partitions (generated in {time.monotonic() - t0:.1f} s)")

    # the polish phases' skip tests: how many ran, and the K7 launches they made
    polish_skips = {"tests": 0, "skipped": 0, "k7": 0}
    inner_skip = opt._polish_skip

    def counted_skip(*args):
        before = kernels.launches()["state_fingerprint"]
        skip = inner_skip(*args)
        polish_skips["tests"] += 1
        polish_skips["skipped"] += int(skip)
        polish_skips["k7"] += kernels.launches()["state_fingerprint"] - before
        return skip

    opt._polish_skip = counted_skip

    solves = {}
    results = {}

    def run_and_check(label, model_s, solve, path, ref, ref_moves, polish=False, excluded=None,
                      measured=None):
        """Run `solve()` (it returns an OptimizerResult) with every kernel's
        launch count set to 0 just before and read just after, and check its
        result: the kernels of its path launched, no goal worse (unless the
        JAX run's row is worse too), no replica on a dead broker (but those of
        the `excluded` partitions, bool[P], which may not move),
        sanity_check, the proposals replay, and the decision digest and final
        assignment equal the JAX CPU run's. `model_s` may be a function that
        returns the solved model once `solve()` has run. `measured` =
        (launch counts, wall seconds) of a solve the caller ran and counted
        itself (`solve()` then returns its result). Returns the result."""
        polish_skips.update(tests=0, skipped=0, k7=0)
        if measured is None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            t0 = time.monotonic()
            res = solve()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = kernels.launches()
        else:
            res, (counts, wall) = solve(), measured
        if callable(model_s):
            model_s = model_s()
        dead_ids = np.nonzero(model_s.broker_state.numpy() == 3)[0]
        k3_paths = dict(score_candidates.paths)
        k5_paths = dict(score_swaps.paths)
        peak = torch.cuda.max_memory_allocated()
        for key in path:
            if counts[key] == 0:
                fail(f"{label}: the solve never launched kernel {key}")
        print(f"{label}: K3 launches by path {k3_paths}, K5 {k5_paths}")
        if label == "service bucketed" and min(
                k3_paths.get(x, 0) for x in ("factored", "promotion", "general")) == 0:
            fail(f"{label}: K3 did not take each of its three paths ({k3_paths})")
        print(f"{label}: {wall:.2f} s wall (kernel builds excluded), peak device memory "
              f"{peak / 2**20:.1f} MiB, launches {counts}")
        if ref_moves is not None:
            print(f"{label}: {res.num_replica_moves} replica moves, {res.num_leadership_moves} "
                  f"leadership moves (JAX on a CPU: {ref_moves['replica']}, "
                  f"{ref_moves['leadership']})")
        print(f"{'goal':36s} {'viol':>11s} {'rounds':>6s} {'conv':>5s} "
              f"{'cost before -> after':>28s}   | JAX on a CPU")
        final = res.final_assignment
        for g in res.goal_results:
            rf = ref[g.name]
            same = (g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                    g.converged) == rf[:4]
            print(f"{g.name:36s} {g.violated_brokers_before:5d}->{g.violated_brokers_after:<5d} "
                  f"{g.rounds:6d} {str(g.converged):>5s} {g.cost_before:13.6g} -> "
                  f"{g.cost_after:<12.6g}   | {rf[0]}->{rf[1]} r{rf[2]} {rf[3]} {rf[4]:.6g} -> "
                  f"{rf[5]:.6g}{'' if same else '   DIFFERS'}")
            jax_worse = rf[1] > rf[0] or rf[5] > rf[4] * (1 + 1e-3)
            if g.violated_brokers_after > g.violated_brokers_before and not jax_worse:
                fail(f"{label}: {g.name}: violated brokers grew")
            if g.cost_after > g.cost_before * (1 + 1e-6) and not jax_worse:
                fail(f"{label}: {g.name}: cost grew")
        movable = np.ones(final.shape[0], bool) if excluded is None else ~np.asarray(excluded)
        on_dead = np.isin(final, dead_ids) & (final >= 0)
        if on_dead[movable].any():
            fail(f"{label}: {int(on_dead[movable].sum())} replicas left on dead brokers")
        if excluded is not None:
            print(f"{label}: {int(on_dead[~movable].sum())} replicas of the "
                  f"{int((~movable).sum())} excluded partitions stay on dead brokers")
        sanity_check(model_s._replace(assignment=torch.from_numpy(final)))
        replay = model_s.assignment.numpy().copy()
        for pr in res.proposals:
            rrow = np.full(replay.shape[1], -1, dtype=replay.dtype)
            rrow[: len(pr.new_replicas)] = pr.new_replicas
            replay[pr.partition] = rrow
        if [set(x[x >= 0]) for x in replay] != [set(x[x >= 0]) for x in final] or not (
                replay[:, 0] == final[:, 0]).all():
            fail(f"{label}: proposals do not replay to the final assignment")
        print(f"{label}: 0 replicas on dead brokers, no goal worse, sanity_check passed, "
              "proposals replay to the final assignment")
        digest = hashlib.sha256(np.ascontiguousarray(final, dtype=np.int32).tobytes()).hexdigest()
        tags = hashlib.sha256(np.ascontiguousarray(res.touch_tag).tobytes()).hexdigest()
        names = [g.name for g in res.goal_results]
        dg = res.provenance.digest(goals=names)
        print(f"{label}: decision digest {dg['checksum']}, {dg['moves']} moves, by goal "
              f"{json.dumps(dg['byGoal'])}")
        jref = JAX_CPU_DIGESTS[label]
        print(f"{label}: JAX on a CPU: digest {jref[0]}, final assignment SHA-256 "
              f"{'equal' if jref[2] == digest else 'differs'}")
        if dg["checksum"] != jref[0] or digest != jref[2]:
            first = next((n for n in names if dg["byGoal"].get(n, 0) != jref[1].get(n, 0)), None)
            print(f"{label}: the decision digest or the final assignment DIFFERS from the JAX "
                  f"CPU run's; first goal whose move count differs: {first} "
                  f"({dg['byGoal'].get(first, 0) if first else '-'} vs "
                  f"{jref[1].get(first, 0) if first else '-'})")
            fail(f"{label}: the decision digest or the final assignment differs from the JAX "
                 "CPU run's")
        print(f"{label}: the decision digest and the final assignment equal the JAX CPU run's")
        if polish:
            polish_segs = [sg for sg in res.provenance.segments if sg.phase == "polish"]
            if len(polish_segs) != len(names) or polish_skips["tests"] < len(names) or \
                    polish_skips["k7"] == 0:
                fail(f"{label}: the polish phases did not run their K7 skip tests "
                     f"({len(polish_segs)} polish segments, {polish_skips})")
            print(f"{label}: {len(polish_segs)} polish phases; {polish_skips['tests']} skip tests "
                  f"launched K7 {polish_skips['k7']} times and skipped {polish_skips['skipped']} "
                  "phases")
        print(f"{label}: stats_after {json.dumps(stats_to_dict(res.stats_after))}")
        solves[label] = {"wall_s": wall, "replica_moves": res.num_replica_moves,
                         "polish_skip_tests": dict(polish_skips),
                         "leadership_moves": res.num_leadership_moves, "peak_bytes": peak,
                         "final_assignment_sha256": digest, "touch_tag_sha256": tags,
                         "decision_digest": dg["checksum"], "launches": counts,
                         "k3_paths": k3_paths, "k5_paths": k5_paths,
                         "goals": [[g.name, g.violated_brokers_before, g.violated_brokers_after,
                                    g.rounds, g.converged, g.cost_before, g.cost_after]
                                   for g in res.goal_results]}
        results[label] = (digest, tags, dg["checksum"])
        return res

    optimizers = {}
    pinned_service = dataclasses.replace(opt.SERVICE_SETTINGS, chunk_target_s=PINNED_TARGET_S)
    for label, model_s, settings, goal_names, path, ref, ref_moves in (
            ("hard goals", model_cpu, dataclasses.replace(opt.SLICE_SETTINGS, ledger=True),
             HARD_GOAL_NAMES, HARD_PATH, JAX_CPU_REFERENCE, JAX_CPU_MOVES),
            ("stack", model_cpu, dataclasses.replace(opt.STACK_SETTINGS, ledger=True), None,
             STACK_PATH, JAX_CPU_STACK_REFERENCE, JAX_CPU_STACK_MOVES),
            ("service", model_cpu, opt.SERVICE_EXACT_SETTINGS, None, STACK_PATH,
             JAX_CPU_STACK_REFERENCE, JAX_CPU_STACK_MOVES),
            ("service hard goals", model_cpu, opt.SERVICE_EXACT_SETTINGS, HARD_GOAL_NAMES,
             HARD_PATH, JAX_CPU_REFERENCE, None),
            ("stack hard goals", model_cpu, dataclasses.replace(opt.STACK_SETTINGS, ledger=True),
             HARD_GOAL_NAMES, HARD_PATH, JAX_CPU_REFERENCE, None),
            ("bench batched", bench_model, opt.BENCH_SETTINGS, None, BENCH_PATH,
             JAX_CPU_BENCH_REFERENCE, JAX_CPU_BENCH_MOVES),
            ("parity greedy", parity_model, opt.GREEDY_SETTINGS, None, GREEDY_PATH,
             JAX_CPU_PARITY_GREEDY_REFERENCE, JAX_CPU_PARITY_GREEDY_MOVES),
            ("parity batched", parity_model, opt.BENCH_SETTINGS, None, BENCH_PATH,
             JAX_CPU_PARITY_BATCHED_REFERENCE, JAX_CPU_PARITY_BATCHED_MOVES),
            ("service bucketed", model_cpu, opt.SERVICE_SETTINGS, None, STACK_PATH,
             JAX_CPU_SERVICE_BUCKETED_REFERENCE, JAX_CPU_SERVICE_BUCKETED_MOVES),
            ("bench bucketed", bench_model, opt.BENCH_BUCKETED_SETTINGS, None, BENCH_PATH,
             JAX_CPU_BENCH_BUCKETED_REFERENCE, JAX_CPU_BENCH_BUCKETED_MOVES)):
        settings = dataclasses.replace(settings, chunk_target_s=PINNED_TARGET_S)
        optimizers[label] = o = opt.GoalOptimizer(device="cuda", settings=settings)
        res = run_and_check(label, model_s,
                            lambda o=o, m=model_s, g=goal_names: o.optimizations(
                                m, g, raise_on_hard_failure=False),
                            path, ref, ref_moves, polish=settings.polish_rounds > 0)
        if settings.bucket_brokers:
            print(f"{label}: bucketed {json.dumps(res.bucketed)}")
            if res.bucketed["paddedBrokers"] <= 0 or res.bucketed["paddedPartitions"] <= 0:
                fail(f"{label}: the solve did not pad both axes")
        if label == "service bucketed" and res.bucketed != JAX_CPU_SERVICE_BUCKETED_BLOCK:
            fail(f"{label}: the bucket record differs from the JAX CPU run's")
        if label.startswith("parity"):
            results[label] = res
        if label != "service bucketed":
            del optimizers[label]
        del res

    # -- 12. the incremental lane, armed on the bucketed service solve ---------------
    from cruise_control_torch.analyzer import incremental as inc
    from cruise_control_torch.analyzer.context import OptimizationOptions

    lane_opt, options = optimizers.pop("service bucketed"), OptimizationOptions()
    all_names = [g.name for g in goals_by_priority(None)]
    lane = inc.IncrementalLane(lane_opt)
    if not lane.arm(model_cpu, options, all_names, generation=1):
        fail("lane: the service solve left no prep-cache entry to arm from")
    entry = lane_opt.prepared_entry(model_cpu, options)
    armed_before = [t.clone() for t in (*entry[1], *entry[3])]
    scratch_opt = opt.GoalOptimizer(device="cuda", settings=pinned_service)
    lane_a, lane_b = lane_perturbations({k: v.numpy() for k, v in model_cpu._asdict().items()})
    for label, fields_s, gen, ref, ref_moves in (
            ("lane a", lane_a, 2, JAX_CPU_LANE_A_REFERENCE, JAX_CPU_LANE_A_MOVES),
            ("lane b", lane_b, 3, JAX_CPU_LANE_B_REFERENCE, JAX_CPU_LANE_B_MOVES)):
        fresh = from_numpy(fields_s)
        outcome = {}

        def propose(fresh=fresh, gen=gen, outcome=outcome):
            outcome["out"] = out = lane.propose(fresh, generation=gen)
            if not out.ok:
                fail(f"lane: the proposal fell back ({out.fallback_reason})")
            return out.result

        res = run_and_check(label, fresh, propose, LANE_PATH, ref, ref_moves)
        out = outcome["out"]
        affected = list(out.affected)
        unaffected = [n for n in all_names if n not in out.affected]
        moved_out = res.provenance.digest(goals=unaffected)["moves"]
        if moved_out:
            fail(f"{label}: the unaffected goals made {moved_out} moves")
        t0 = time.monotonic()
        scratch = scratch_opt.optimizations(fresh, affected, raise_on_hard_failure=False)
        torch.cuda.synchronize()
        scratch_s = time.monotonic() - t0
        same = (scratch.provenance.digest(goals=affected) == res.provenance.digest(goals=affected)
                and np.array_equal(scratch.final_assignment, res.final_assignment))
        solves[label].update(deltas=out.summary()["deltasByKind"], affected=affected,
                             scratch_wall_s=scratch_s, incremental=res.bucketed.get("incremental"))
        print(f"{label}: {len(out.deltas)} deltas {json.dumps(out.summary()['deltasByKind'])}, "
              f"{len(affected)} goals affected, {len(unaffected)} left out with 0 moves; lane "
              f"{solves[label]['wall_s']:.2f} s against the scratch solve of the same goals "
              f"{scratch_s:.2f} s; K10 launched {solves[label]['launches']['delta_scatter']} "
              f"time(s)")
        if not same:
            fail(f"{label}: the lane's proposal differs from the scratch solve of the same goals")
        print(f"{label}: decision digest and final assignment equal the scratch solve's")
        del res, scratch
    if not all(torch.equal(x, y) for x, y in zip(armed_before, (*entry[1], *entry[3]))):
        fail("lane: the armed prep-cache entry changed")
    print("lane: the armed prep-cache entry is unchanged after both proposals")
    del lane, lane_opt, scratch_opt, entry, armed_before
    opt._polish_skip = inner_skip

    # -- 13.-17. the options, each a JAX facade flow (option_recipes) -------------
    from cruise_control_torch.analyzer.context import resolve_options
    from cruise_control_torch.models.generators import topic_names

    recipes = option_recipes({k: v.numpy() for k, v in model_cpu._asdict().items()})
    for label, (fields_s, goal_names, okw, mult) in recipes.items():
        model_s = from_numpy(fields_s)
        options = resolve_options(OptimizationOptions(**okw), model_s, topic_names(model_s))
        constraint_s = dataclasses.replace(
            BalancingConstraint.default(), goal_violation_distribution_threshold_multiplier=mult)
        o = opt.GoalOptimizer(constraint=constraint_s, device="cuda", settings=pinned_service)
        k11_out = {}

        def solve(o=o, m=model_s, g=goal_names, options=options, label=label, c=constraint_s,
                  k11_out=k11_out):
            res = o.optimizations(m, g, options, raise_on_hard_failure=False)
            if label == "demote":
                # the demote flow's preferred-leader election (K11) on the
                # demoted model's initial and final assignments
                m_g = m.to(dev)
                st = build_static_ctx(m_g, c, dims_of(m))
                k11_out["initial"] = elect_preferred_leaders(st, m_g.assignment)
                k11_out["final"] = elect_preferred_leaders(
                    st, torch.from_numpy(res.final_assignment).to(dev))
            return res

        res = run_and_check(label, model_s, solve, OPTION_PATH[label],
                            JAX_CPU_OPTION_REFERENCE[label], JAX_CPU_OPTION_MOVES[label],
                            excluded=options.excluded_partitions)
        print(f"{label}: options {sorted(okw)}; bucketed {json.dumps(res.bucketed)}")
        if res.bucketed != JAX_CPU_SERVICE_BUCKETED_BLOCK:
            fail(f"{label}: the bucket record differs from the JAX CPU run's")
        if label == "kafka-assigner":
            cases = dict(score_candidates.cases)
            solves[label]["k3_cases"] = cases
            if cases.get(15, 0) == 0:
                fail(f"{label}: K3's goal case 15 never launched")
            print(f"{label}: K3 launches by goal case {cases}")
        if label == "demote":
            st_c11 = build_static_ctx(model_s, constraint_s, dims_of(model_s))
            for which, a_ in (("initial", model_s.assignment),
                              ("final", torch.from_numpy(res.final_assignment))):
                out = k11_out[which].cpu()
                if not bits_equal(out, elect_preferred_plain(a_, st_c11.demoted, st_c11.dead)):
                    fail(f"{label}: K11 on the {which} assignment differs from the plain version")
                sha = hashlib.sha256(np.ascontiguousarray(out.numpy(), dtype=np.int32)
                                     .tobytes()).hexdigest()
                if sha != JAX_CPU_K11_SHA256[which]:
                    fail(f"{label}: K11 on the {which} assignment differs from JAX's "
                         "elect_preferred_leaders")
                moved = int((out[:, 0] != a_[:, 0]).sum())
                solves[label][f"k11_{which}_leaders_moved"] = moved
                print(f"{label}: K11 on the {which} assignment moved {moved} leaders, SHA-256 "
                      "equal to JAX's elect_preferred_leaders")
        del res, o

    # -- 18. monitored proposal: the load monitor's path, then the service solve --
    from types import SimpleNamespace

    from cruise_control_torch.common.sensors import REGISTRY
    from cruise_control_torch.common.tracing import TRACER
    from cruise_control_torch.models.flat_model import to_numpy
    from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
    from cruise_control_torch.monitor.load_monitor import LoadMonitor, LoadMonitorConfig
    from cruise_control_torch.monitor.metadata import MetadataClient
    from cruise_control_torch.monitor.sampler import TransportMetricSampler
    from cruise_control_torch.reporter.transport import InMemoryTransport
    from cruise_control_torch.testing.simulator import SimulatedCluster

    card = nvidia_smi_line()
    monitor_ns = SimpleNamespace(
        SimulatedCluster=SimulatedCluster, InMemoryTransport=InMemoryTransport,
        MetadataClient=MetadataClient, TransportMetricSampler=TransportMetricSampler,
        LoadMonitor=LoadMonitor, LoadMonitorConfig=LoadMonitorConfig,
        ModelCompletenessRequirements=ModelCompletenessRequirements)
    model_m, meta_m, host_s, ingested, sim_m, monitor_m = monitored_model(model_cpu, monitor_ns)
    print(f"monitored: {MONITOR_WINDOWS} windows of {model_cpu.num_brokers} brokers' metrics: "
          f"emission {host_s['emit']:.3f} s, sampling {host_s['sample']:.3f} s ({ingested} "
          f"samples), model build {host_s['build']:.3f} s of host time ({card})")
    for k, v in model_sha256(to_numpy(model_m)).items():
        if v != JAX_CPU_MONITORED_MODEL_SHA256[k]:
            fail(f"monitored: the monitored model's {k} differs from the JAX monitor's (host "
                 "numpy, before any solve)")
    print("monitored: every array of the monitored model equals the JAX monitor's (SHA-256)")
    zero = int((model_m.part_load.sum(dim=1) == 0).sum())
    print(f"monitored: {model_m.num_partitions} partitions, {zero} with no load (led by dead "
          "brokers, which report nothing)")
    o_m = opt.GoalOptimizer(device="cuda", settings=pinned_service)
    res = run_and_check("monitored", model_m,
                        lambda: o_m.optimizations(model_m, None, raise_on_hard_failure=False),
                        STACK_PATH, JAX_CPU_MONITORED_REFERENCE, JAX_CPU_MONITORED_MOVES)
    if res.bucketed != JAX_CPU_SERVICE_BUCKETED_BLOCK:
        fail("monitored: the bucket record differs from the JAX CPU run's")
    print(f"monitored: the solve took {solves['monitored']['wall_s']:.2f} s ({card})")
    sensors = {k: (v.get("count") if isinstance(v, dict) else v)
               for k, v in REGISTRY.snapshot().items()}
    print(f"monitored: REGISTRY sensors (count or value) {json.dumps(sensors, default=str)}")
    print(f"monitored: TRACER span kinds {json.dumps(TRACER.summarize())}")
    del o_m

    # -- 19. executed: phase 18's proposal executed on the simulated cluster --
    executed = executed_phase(res, model_m, meta_m, sim_m, monitor_m, card)

    # -- 20. self-healing: a broker of phase 19's cluster killed, detected,
    # decommissioned through the facade on the card, executed over the wire --
    healed = {}

    def heal():
        healed.update(self_healing(sim_m, monitor_m, package_classes(
            "cruise_control_torch", SELF_HEALING_CLASSES), device="cuda"))
        if healed["action"] != "FIX" or healed["result"] is None or any(
                healed["fix_failures"].values()):
            fail(f"self-healing: the detector decided {healed['action']}, fix failures "
                 f"{healed['fix_failures']}")
        return healed["result"]

    res = run_and_check("broker failure", lambda: healed["model"], heal, SELF_HEALING_PATH,
                        JAX_CPU_SELF_HEALING_REFERENCE, JAX_CPU_SELF_HEALING["moves"])
    solves["broker failure"]["wall_s"] = healed["seconds"]["solve"]
    rec = self_healing_record(healed, sim_m)
    print(f"self-healing: broker {rec['victim']} killed; the sweep queued {rec['queued']} "
          f"anomalies {json.dumps(rec['detected'])}; the handler decided {rec['action']}, "
          f"fixes {json.dumps(rec['fixesTriggered'])}; bucketed {json.dumps(res.bucketed)}")
    print(f"self-healing: executed over the wire {json.dumps(rec['executed'])}")
    for key, want in JAX_CPU_SELF_HEALING.items():
        if rec[key] != want:
            fail(f"self-healing: {key} {rec[key]} differs from the JAX run's {want}")
    if any(a["anomalyType"] == "GOAL_VIOLATION" for a in rec["detected"]):
        fail("self-healing: the goal-violation detector reported with a broker dead")
    by = rec["executed"]["byState"]
    if by["COMPLETED"] != rec["executed"]["numTotalMovements"] or healed["summary"][
            "failedTasks"]:
        fail(f"self-healing: not every task completed {by}")
    topo = sim_m.fetch_topology()
    dead = np.nonzero(topo.broker_state == 3)[0]
    if np.isin(topo.assignment, dead).any():
        fail(f"self-healing: {int(np.isin(topo.assignment, dead).sum())} replicas left on dead "
             "brokers after the execution")
    print("self-healing: the victim, the anomalies, the decision, the decommission's moves and "
          "the execution over the wire (counts, trims, dispatch order, the cluster afterwards) "
          f"equal the JAX run's; no replica on the {len(dead)} dead brokers")
    sec = healed["seconds"]
    print("self-healing: host seconds: " + ", ".join(
        f"{k} {sec[k]:.3f}" for k in ("detection", "model build", "solve", "stamping",
                                      "execution")) + f"; {rec['executed']['numTotalMovements']}"
          f" tasks in {rec['executed']['batches']} batches ({card})")
    executed["self_healing"] = dict(seconds=sec, record=rec)
    del res, healed

    # -- 21. served: the REST front end on phase 20's cluster, on the card --
    executed["served"] = served_phase(sim_m, monitor_m, name, card, run_and_check)
    del model_m, sim_m, monitor_m

    # -- 22. main: the entry point as users start it --------------------------
    executed["main"] = entry_point_phase(name, card)

    # -- 23. mesh: the partition-axis mesh on shards of the card --------------
    executed["mesh"] = mesh_phase(model_cpu, parity_model, card, row, run_and_check, solves)

    if results["service"][:2] != results["stack"][:2]:
        fail("service: the chunked solve's final assignment or touch tags differ from the "
             "fused stack solve's")
    print("service: final assignment and touch tags hash the same as the fused stack solve's")
    if results["service hard goals"] != results["stack hard goals"]:
        fail("service hard goals: the machine's subset solve differs from the fused stack "
             "run of the same six goals")
    print("service hard goals: equal to the fused stack run of the six goals (assignment, "
          "touch tags, decision digest)")
    gate = parity_gate(results["parity batched"], results["parity greedy"])
    print(f"parity: {json.dumps(gate)}")
    if not gate["parityOk"]:
        fail("parity: the batched pass is worse than the greedy pass (bench.py's parity gate)")
    solves["parity batched"]["parity"] = gate

    # `launches` is the count of the path each kernel carries: the service's
    # default solve's (bucketed, the main path), for K9 the greedy pass's, for
    # K10 the lane's first proposal, for K12 the mesh's greedy pass and for
    # K13 the mesh's coverage certificate; every solve's count is kept beside it
    main = {"grid_shortlist": "parity greedy", "delta_scatter": "lane a",
            "elect_preferred": "demote", "shard_merge": "mesh parity greedy",
            "partition_stats": "mesh certificate"}
    n_k4 = solves["service bucketed"]["launches"]["apply_wave"]
    print(f"K4 apply_wave on the service bucketed solve: {n_k4} launches x "
          f"{k4_bulk['ms']:.4f} ms (bulk wave) = {n_k4 * k4_bulk['ms'] / 1e3:.3f} s, x "
          f"{k4_drain['ms']:.4f} ms (drain wave) = {n_k4 * k4_drain['ms'] / 1e3:.3f} s, x "
          f"{rows['apply_wave']['ms']:.4f} ms (relay wave) = "
          f"{n_k4 * rows['apply_wave']['ms'] / 1e3:.3f} s of device time")
    for key, v in rows.items():
        v["launches"] = solves[main.get(key, "service bucketed")]["launches"][key]
        for label in solves:
            v["launches_" + label.replace(" ", "_")] = solves[label]["launches"][key]
    total_s = time.monotonic() - t_start
    print(json.dumps({"solves": solves, "executed": executed, "build_s": build_s,
                      "kernel_rows_s": kernel_rows_s, "chip_smoke_s": total_s}))
    for k, v in rows.items():
        print(f"{k:20s} {v['ms']:9.4f} ms on the device per call, {v['call_ms']:9.4f} ms per "
              f"call (plain {v['plain_ms']:9.4f} ms, bound {v['bound_ms']:.6f} ms by "
              f"{v['bound_by']}), {v['launches']} launches in its path's solve")
    print(f"chip_smoke: {total_s:.1f} s in all, kernel builds {build_s:.2f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [rows[k] for k in ALL_KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
