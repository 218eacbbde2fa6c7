"""The taxonomy grid as named scenarios and sweeps.

Every cell the benchmarks and examples used to hand-assemble is declared
here once: workload spec x policy suite x platform profile x cluster
shape.  Benchmarks (``bench_csf``, ``bench_qos``, ``bench_platforms``,
``bench_tradeoffs``, ``bench_tiers``, ``bench_fleet``) and examples
(``coldstart_study``, ``fleet_demo``) are thin declarations over this
registry; the CLI (``python -m repro.experiments``) runs any of it with
zero new plumbing.

Seed policy: workloads whose numbers back a tuned acceptance gate pin
their historical trace seed explicitly; everything else derives its trace
seed from ``Scenario.seed`` (one master seed per scenario).  The shared
``azure_long`` workload replaces the formerly-divergent hardcoded seeds of
``bench_tradeoffs`` (31) and ``bench_platforms`` (41) with one derived
stream — the same trace now underlies both studies.
"""
from __future__ import annotations

from repro_torch.experiments.registry import register, register_sweep
from repro_torch.experiments.spec import (ClusterSpec, EngineSpec, Scenario,
                                          WorkloadSpec)
from repro_torch.experiments.sweep import AxisValue, Sweep


def _w(generator: str, name=None, seed=None, **params) -> WorkloadSpec:
    return WorkloadSpec(generator, params, seed=seed, name=name)


# --------------------------------------------------------------------------- #
# workload specs (the trace column of the grid)
# --------------------------------------------------------------------------- #
AZURE_TAXONOMY = _w("azure_like", "azure", seed=11, horizon=900.0,
                    num_functions=25)
BURSTY = _w("bursty", seed=12, base_rate=0.05, burst_rate=8.0, horizon=600.0,
            num_functions=4)
DIURNAL = _w("diurnal", seed=13, peak_rate=2.0, horizon=900.0, period=300.0,
             num_functions=4)
RARE_CSF = _w("rare", seed=14, inter_arrival=130.0, horizon=2000.0,
              num_functions=4)
AZURE_LONG = _w("azure_like", "azure_long", horizon=900.0, num_functions=20)
AZURE_FLEET = _w("azure_like", "azure_like", seed=11, horizon=600.0,
                 num_functions=20)
FLASH_CROWD = _w("flash_crowd", seed=1, base_rate=0.5, spike_rate=40.0,
                 horizon=300.0, num_functions=4)
RARE_TIERS = _w("rare", "rare", seed=5, inter_arrival=150.0, horizon=30000.0,
                jitter=0.3, num_functions=4)
POISSON_QOS = _w("poisson", seed=21, rate=0.2, horizon=1500.0,
                 num_functions=5)
AZURE_CALIB = _w("azure_like", "azure_calib", seed=7, horizon=300.0,
                 num_functions=12)
AZURE_STUDY = _w("azure_like", "azure_study", seed=0, horizon=900.0,
                 num_functions=25)
CHAINS3 = _w("chains", seed=1, rate=0.05, horizon=600.0, chain_len=3)
RARE_ENGINE = _w("rare", "rare_engine", seed=3, inter_arrival=120.0,
                 horizon=600.0, jitter=0.05, num_functions=1)
# calibration probes for scripts/recalibrate.py: one uncontended function
# whose revisit gap lands inside a specific tiered_fixed ladder dwell
# (warm 45s / paused ends 600s / snapshot ends 2400s), so every startup
# event measures exactly one promote edge
RARE_PAUSED = _w("rare", "rare_paused", seed=9, inter_arrival=90.0,
                 horizon=420.0, jitter=0.05, num_functions=1)
RARE_SNAPSHOT = _w("rare", "rare_snapshot", seed=9, inter_arrival=700.0,
                   horizon=2200.0, jitter=0.05, num_functions=1)
FLASH_CONC4 = _w("flash_crowd", "flash_conc4", seed=1, base_rate=0.5,
                 spike_rate=30.0, horizon=120.0, num_functions=2,
                 container_concurrency=4)
POISSON_HET = _w("poisson", "poisson_het", seed=3, rate=2.0, horizon=200.0,
                 num_functions=6)

SMALL_CLUSTER = ClusterSpec(num_workers=2, worker_memory_mb=4096.0)
CALIB_CLUSTER = ClusterSpec(num_workers=2, worker_memory_mb=8192.0)

# --------------------------------------------------------------------------- #
# base scenarios
# --------------------------------------------------------------------------- #
CSF = register(Scenario(
    name="csf", workload=AZURE_TAXONOMY, policy="provider_default",
    calibrated=True,
    description="Table 5 base: CSF techniques on the taxonomy traces"))

QOS = register(Scenario(
    name="qos", workload=POISSON_QOS, policy="provider_short",
    slo_latency_s=0.5,
    description="RQ1/Fig.11 base: cold-start impact on QoS parameters"))

PLATFORMS = register(Scenario(
    name="platforms", workload=AZURE_LONG, policy="platform_default",
    platform="aws_lambda",
    description="RQ4/S5.4 base: one workload across platform profiles"))

TRADEOFFS = register(Scenario(
    name="tradeoffs", workload=AZURE_LONG, policy="provider_short",
    description="S6 base: frequency-vs-waste Pareto + predictor study"))

TIERS = register(Scenario(
    name="tiers", workload=AZURE_FLEET, policy="tiered_spes",
    description="Warmth-tier ladder base: graded vs binary keep-alive"))

FLEET = register(Scenario(
    name="fleet", workload=AZURE_FLEET, policy="provider_default",
    calibrated=True,
    description="Fleet replay base: policy comparison on the live twin"))

STUDY = register(Scenario(
    name="study", workload=AZURE_STUDY, policy="provider_default",
    description="coldstart_study base: full catalog on an Azure-like mix"))

register(Scenario(
    name="study_chains", workload=CHAINS3, policy="provider_short",
    description="3-stage chain workload (fusion / cascading cold starts)"))

register(Scenario(
    name="engine_smoke", workload=RARE_ENGINE, policy="prewarm_histogram",
    keepalive_ttl=20.0, cluster=ClusterSpec(num_workers=1,
                                            worker_memory_mb=4096.0),
    engine=EngineSpec(arch="xlstm-125m", max_seq=16, batch=1, decode_steps=2,
                      clock_speed=60.0, snapshots=True),
    description="real engines on a 60x wall clock: sparse trace where every"
                " hit is cold unless the histogram prewarm restores in time"))

# fleet-only levers on a constrained cluster (the spike must queue)
for label, cluster in [
        ("serial", SMALL_CLUSTER),
        ("batch8", ClusterSpec(num_workers=2, worker_memory_mb=4096.0,
                               max_batch=8)),
        ("slots4", ClusterSpec(num_workers=2, worker_memory_mb=4096.0,
                               slots_per_replica=4))]:
    register(Scenario(
        name=f"fleet_levers/{label}", workload=FLASH_CROWD,
        policy="provider_default", cluster=cluster, calibrated=True,
        description="fleet-only lever under a queue-forcing flash crowd"))

# sim-vs-fleet calibration cells (ledger-identity checked via compare())
CALIBRATION = {}
for label, sc in [
    ("default", Scenario(
        name="calib/default", workload=AZURE_FLEET,
        policy="provider_default", calibrated=True,
        description="baseline sim-vs-fleet ledger-identity cell")),
    ("concurrency4", Scenario(
        name="calib/concurrency4", workload=FLASH_CONC4,
        policy="provider_default", cluster=SMALL_CLUSTER, calibrated=True,
        description="container_concurrency=4 slot-sharing identity cell")),
    ("heterogeneous", Scenario(
        name="calib/heterogeneous", workload=POISSON_HET,
        policy="provider_default", calibrated=True,
        cluster=ClusterSpec(num_workers=3,
                            worker_memory_mb=(8192.0, 4096.0, 2048.0),
                            worker_speed=(1.0, 0.5, 2.0)),
        description="heterogeneous-worker identity cell")),
    ("tiered_fixed", Scenario(
        name="calib/tiered_fixed", workload=AZURE_CALIB,
        policy="tiered_fixed", cluster=CALIB_CLUSTER, calibrated=True,
        description="static warmth-ladder identity cell")),
    ("tiered_spes", Scenario(
        name="calib/tiered_spes", workload=AZURE_CALIB,
        policy="tiered_spes", cluster=CALIB_CLUSTER, calibrated=True,
        description="SPES-style predictive-ladder identity cell "
                    "(the CI ledger-identity smoke scenario)")),
    ("pause_pool", Scenario(
        name="calib/pause_pool", workload=AZURE_CALIB,
        policy="pause_pool", cluster=CALIB_CLUSTER, calibrated=True,
        description="generic pause-pool identity cell")),
    ("engine_paused", Scenario(
        name="calib/engine_paused", workload=RARE_PAUSED,
        policy="tiered_fixed", calibrated=True,
        cluster=ClusterSpec(num_workers=1, worker_memory_mb=4096.0),
        engine=EngineSpec(arch="xlstm-125m", max_seq=16, batch=1,
                          decode_steps=2, clock_speed=120.0, snapshots=True),
        description="recalibration probe: ~90s revisit gap lands in the "
                    "PAUSED dwell — every restart measures the thaw edge")),
    ("engine_snapshot", Scenario(
        name="calib/engine_snapshot", workload=RARE_SNAPSHOT,
        policy="tiered_fixed", calibrated=True,
        cluster=ClusterSpec(num_workers=1, worker_memory_mb=4096.0),
        engine=EngineSpec(arch="xlstm-125m", max_seq=16, batch=1,
                          decode_steps=2, clock_speed=240.0, snapshots=True),
        description="recalibration probe: ~700s revisit gap lands in the "
                    "SNAPSHOT_READY dwell — every restart measures restore")),
]:
    CALIBRATION[label] = register(sc)

# --------------------------------------------------------------------------- #
# trace-scale stress cells (ROADMAP item 2): streamed azure_full sources —
# the sim driver consumes them with bounded memory (the trace cache is
# bypassed, arrivals merge into the heap incrementally); bench_simcore's
# stress tier measures heap-events/s and peak RSS at these scales
# --------------------------------------------------------------------------- #
# azure_stress replays a real downloaded Azure Functions CSV when
# $REPRO_AZURE_CSV (or the --azure-csv CLI flag) points at one, and
# falls back to the synthetic azure_full twin otherwise
AZURE_10K = _w("azure_stress", "azure_10k", seed=2019, horizon=600.0,
               num_functions=10_000, rate_per_s=100.0)
AZURE_50K = _w("azure_stress", "azure_50k", seed=2019, horizon=600.0,
               num_functions=50_000, rate_per_s=150.0)
STRESS_CLUSTER = ClusterSpec(num_workers=8, worker_memory_mb=2_000_000.0)

register(Scenario(
    name="stress/azure10k", workload=AZURE_10K, policy="provider_default",
    cluster=STRESS_CLUSTER,
    description="10k-function streamed Azure replay — real CSV via "
                "$REPRO_AZURE_CSV / --azure-csv, synthetic twin otherwise "
                "(bench_simcore stress tier; ~100 arrivals/s)"))
register(Scenario(
    name="stress/azure50k", workload=AZURE_50K, policy="provider_default",
    cluster=STRESS_CLUSTER,
    description="50k-function streamed Azure replay (real CSV via "
                "$REPRO_AZURE_CSV when present) — the SPES-scale regime; "
                "memory stays O(live containers), never O(trace)"))

# --------------------------------------------------------------------------- #
# learned-predictor cells (ROADMAP item 3): the bench_learn Pareto gate
# compares identical prewarm suites that differ ONLY in the predictor
# (histogram vs trained transformer).  The cron_spikes eval cells pin
# seeds disjoint from repro.learn.dataset.TRAIN_MIX (whose seeds derive
# from a master seed) — same regime, held-out traces.
# --------------------------------------------------------------------------- #
CRON_A = _w("cron_spikes", "cron_a", seed=101, horizon=18_000.0,
            num_functions=8, base_gap_s=240.0, spike_gap_s=75.0,
            spike_period_s=7200.0, jitter=0.04)
CRON_B = _w("cron_spikes", "cron_b", seed=202, horizon=36_000.0,
            num_functions=6, base_gap_s=400.0, spike_gap_s=90.0,
            spike_period_s=14_400.0, jitter=0.04)

LEARN = register(Scenario(
    name="learn", workload=CRON_A, policy="prewarm_transformer",
    description="learned-forecaster base: cron workload whose sub-p05 "
                "early re-fires the histogram window misses"))

register(Scenario(
    name="learn/gym", workload=_w("azure_like", "gym_azure", seed=1,
                                  horizon=600.0, num_functions=12),
    policy="tiered_fixed",
    description="one cell of the RL keep-alive gym training grid "
                "(repro.learn.gym.training_scenarios)"))

register_sweep(Sweep(
    name="learn_pareto", base=LEARN,
    axes={"workload": (CRON_A, CRON_B, AZURE_TAXONOMY, RARE_TIERS),
          "policy": ("prewarm_histogram", "prewarm_transformer")},
    description="bench_learn Pareto gate: trained transformer vs "
                "histogram predictor behind the identical prewarm suite"))

register_sweep(Sweep(
    name="learn_grid", base=LEARN,
    axes={"workload": tuple(
        _w("azure_like", f"gym_azure_s{s}", seed=s, horizon=600.0,
           num_functions=12) for s in (1, 2, 3, 4)),
          "policy": ("tiered_fixed", "tiered_rl_learned")},
    description="the DQN agent's training grid: exported-schedule replay "
                "vs the static ladder baseline"))

# --------------------------------------------------------------------------- #
# sweeps (the grids the benchmark tables iterate)
# --------------------------------------------------------------------------- #
CSF_POLICIES = ("cold_always", "provider_default", "faascache", "lcs",
                "periodic_ping", "prewarm_ewma", "prewarm_markov",
                "prewarm_histogram", "rl_keepalive", "cas", "ensure",
                "hybrid_prewarm", "beyond_combo")

register_sweep(Sweep(
    name="csf_table5", base=CSF,
    axes={"workload": (AZURE_TAXONOMY, BURSTY, DIURNAL, RARE_CSF),
          "policy": CSF_POLICIES},
    description="Table 5: CSF techniques x four trace families"))

register_sweep(Sweep(
    name="qos_fig11", base=QOS,
    axes={"policy": (
        AxisValue("with_cold_starts", {"policy": "provider_short"}),
        AxisValue("cold_eliminated", {"policy": "periodic_ping"}),
        AxisValue("always_cold", {"policy": "cold_always"}))},
    description="Fig.11: QoS with / without / all cold starts"))

def _platform_axis():
    from repro_torch.core.costmodel import PLATFORM_PROFILES
    return tuple(PLATFORM_PROFILES)


register_sweep(Sweep(
    name="platforms_rq4", base=PLATFORMS,
    axes={"platform": _platform_axis(),
          "policy": (AxisValue("default", {"policy": "platform_default"}),
                     AxisValue("snapshot", {"policy": "snapshot_restore"}))},
    description="RQ4: per-platform cold-start fingerprint + snapshot fix"))

register_sweep(Sweep(
    name="tradeoffs_pareto", base=TRADEOFFS,
    axes={"policy": ("cold_always", "provider_short", "provider_default",
                     "periodic_ping", "prewarm_histogram", "faascache",
                     "beyond_combo")},
    description="S6.1: cold-start frequency vs wasted GB-s Pareto"))

TIERS_BINARY = ("provider_short", "provider_default")
TIERS_GRADED = ("tiered_fixed", "tiered_spes", "tiered_rl")

register_sweep(Sweep(
    name="tiers_pareto", base=TIERS,
    axes={"workload": (AZURE_FLEET, RARE_TIERS),
          "policy": TIERS_BINARY + TIERS_GRADED},
    description="graded warmth ladders vs binary fixed-TTL keep-alive"))

FLEET_POLICY_AXIS = (
    AxisValue("fixed_ttl_60", {"policy": "provider_short"}),
    AxisValue("fixed_ttl_600", {"policy": "provider_default"}),
    AxisValue("histogram_prewarm", {"policy": "prewarm_histogram",
                                    "keepalive_ttl": 50.0}),
    AxisValue("hybrid_prewarm", {"policy": "hybrid_prewarm",
                                 "keepalive_ttl": 50.0}),
    AxisValue("rl_keepalive", {"policy": "rl_keepalive"}),
)

register_sweep(Sweep(
    name="fleet_policies", base=FLEET, driver="fleet",
    axes={"workload": (AZURE_FLEET, FLASH_CROWD),
          "policy": FLEET_POLICY_AXIS},
    description="fleet replay: fixed TTL vs predictor-driven autoscaling"))

register_sweep(Sweep(
    name="fleet_demo", base=FLEET, driver="fleet",
    axes={"policy": (FLEET_POLICY_AXIS[0], FLEET_POLICY_AXIS[1],
                     FLEET_POLICY_AXIS[3], FLEET_POLICY_AXIS[4])},
    description="fleet_demo example: four policies on the azure trace"))


BATCHGRID = register(Scenario(
    name="batchgrid", workload=AZURE_FLEET, policy="provider_default",
    description="batch-driver base: azure trace for the 64-cell "
                "throughput grid (bench_batchsim)"))

register_sweep(Sweep(
    name="batch_grid64", base=BATCHGRID,
    axes={"keepalive_ttl": (15.0, 30.0, 60.0, 120.0, 240.0, 480.0,
                            900.0, 1800.0),
          "workload.params.num_functions": (5, 10, 20, 40),
          "policy": ("provider_short", "tiered_fixed")},
    description="64-cell TTL x scale x policy grid on the azure trace "
                "(every cell batch-supported)"))

# dense grid for the batch-vs-scalar throughput gate: scalar cost scales
# with invocations (~24k per cell at rate 40), batch cost only with the
# step count — the regime where one jitted program replaces 64 event heaps
BATCHDENSE = register(Scenario(
    name="batchdense",
    workload=WorkloadSpec("poisson", {"rate": 60.0, "horizon": 600.0,
                                      "num_functions": 20}, seed=1),
    policy="provider_default",
    # few big workers: 128 container slots keep an all-cold burst
    # (~1.6 s/request occupancy, ~79 req/s capacity) clear of the
    # queueing-collapse boundary, while the small worker *count* keeps
    # the batch step's F x W placement math cheap
    cluster=ClusterSpec(num_workers=4, worker_memory_mb=32768.0),
    description="dense poisson base for the bench_batchsim throughput "
                "grid (~36k invocations per cell)"))

register_sweep(Sweep(
    name="batch_dense64", base=BATCHDENSE,
    axes={"keepalive_ttl": (15.0, 30.0, 60.0, 120.0, 240.0, 480.0,
                            900.0, 1800.0),
          "workload.seed": tuple(range(1, 9))},
    description="64-cell TTL x seed dense-poisson grid — the "
                "bench_batchsim >=50x throughput gate"))


# --------------------------------------------------------------------------- #
# edge–cloud topology cells (ROADMAP item 4): node tiers + network +
# QoS-class offloading (repro.topology).  The Pareto workloads are sized
# so the concurrently-warm set (num_functions x 1 GB) overflows the edge
# tier alone AND the cloud tier alone but fits the two combined — the
# regime where always_local thrashes, always_cloud pays network on every
# request and still thrashes, and a routing policy that PARTITIONS the
# warm set across tiers dominates both (bench_topology's gate).
# --------------------------------------------------------------------------- #
from repro_torch.topology.spec import (NetworkSpec, NodeSpec,  # noqa: E402
                                       TopologySpec)

TOPO_QOS = {"critical": 0.1, "standard": 0.6, "batch": 0.3}
AZURE_TOPO = WorkloadSpec(
    "azure_like", {"horizon": 900.0, "num_functions": 12}, seed=17,
    name="azure_topo", qos_classes=TOPO_QOS)
BURSTY_TOPO = WorkloadSpec(
    "bursty", {"base_rate": 0.2, "burst_rate": 6.0, "horizon": 900.0,
               "num_functions": 12}, seed=18,
    name="bursty_topo", qos_classes=TOPO_QOS)

# edge: small pool, zero network price; cloud: bigger but not big enough
# for the whole warm set, 80 ms away
EDGE_CLOUD = TopologySpec(
    nodes=(NodeSpec("edge", ClusterSpec(num_workers=2,
                                        worker_memory_mb=3072.0)),
           NodeSpec("cloud", ClusterSpec(num_workers=4,
                                         worker_memory_mb=2048.0))),
    network=NetworkSpec(rtt_s={"cloud|edge": 0.08},
                        bandwidth_mbps={"cloud|edge": 200.0}),
    offload="greedy", payload_kb=256.0)

TOPO = register(Scenario(
    name="topo", workload=AZURE_TOPO, policy="provider_default",
    topology=EDGE_CLOUD,
    description="edge–cloud base: cold-start avoidance vs network price "
                "under QoS-class offloading"))

register_sweep(Sweep(
    name="topo/edge_cloud_pareto", base=TOPO,
    axes={"workload": (AZURE_TOPO, BURSTY_TOPO),
          "topology.offload": ("always_local", "always_cloud",
                               "local_first", "greedy", "probabilistic")},
    description="bench_topology Pareto gate: offloading policies vs the "
                "always-local and always-cloud baselines"))

# sim-vs-fleet identity cell: the edge holds only 4 of the 6 functions,
# so greedy genuinely routes cross-node — but BEFORE either node hits
# memory pressure (greedy's eviction penalty steers overflow away first;
# the drivers' queueing disciplines legally diverge under pressure, same
# contract as the flat calib cells), with QoS classes on the gate path
POISSON_TOPO = WorkloadSpec(
    "poisson", {"rate": 0.5, "horizon": 600.0, "num_functions": 6},
    seed=33, name="poisson_topo", qos_classes={"gold": 0.25, "silver": 0.75})

CALIBRATION["topo_basic"] = register(Scenario(
    name="calib/topo_basic", workload=POISSON_TOPO,
    policy="provider_default", calibrated=True,
    topology=TopologySpec(
        nodes=(NodeSpec("edge", ClusterSpec(num_workers=2,
                                            worker_memory_mb=2048.0)),
               NodeSpec("cloud", ClusterSpec(num_workers=2,
                                             worker_memory_mb=8192.0))),
        network=NetworkSpec(rtt_s={"cloud|edge": 0.06},
                            bandwidth_mbps={"cloud|edge": 150.0}),
        offload="greedy", payload_kb=128.0),
    description="edge–cloud identity cell: per-node kernels + shared "
                "router must replay sim-vs-fleet event-identical, with "
                "real cross-node offloads on the path"))


def study_sweep():
    """The full-catalog policy sweep for examples/coldstart_study.py.

    Built lazily (the policy CATALOG import is cheap but keeps this module
    import-light); skips prewarm_lstm — per-step jax on CPU is too slow
    for an example run.
    """
    from repro_torch.core.policies import CATALOG
    return Sweep(
        name="study_catalog", base=STUDY,
        axes={"policy": tuple(n for n in CATALOG if n != "prewarm_lstm")},
        description="every catalog suite on the study workload")


register_sweep(study_sweep())
