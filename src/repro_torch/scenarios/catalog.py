# A copy of src/repro/scenarios/catalog.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port must plan the reference's deployments, field for field.
"""Built-in scenario catalogue.

The four Table-3 settings of the paper plus new deployments that stress
different corners of the QoE space (tight serving latency, per-device
energy budgets, lossy vehicle links, TPU-pod planning).  Device profiles
come from ``core.device.CATALOG``; degraded fleets are derived with
``dataclasses.replace`` so the catalogue stays the single source of
hardware truth.
"""
from __future__ import annotations

import dataclasses

from ..core.adapter import DynamicsEvent
from ..core.cost_model import PAPER_SERVE_WORKLOAD, PAPER_TRAIN_WORKLOAD
from ..core.device import CATALOG, MBPS, LinkResource, Topology, make_setting
from ..core.events import (DiurnalArrivals, FlashCrowdArrivals,
                           interactive_batch)
from ..core.qoe import QoESpec
from . import Scenario, register

# Default paper-style workloads, shared with sim.runner.workload_for.
TRAIN_WL = PAPER_TRAIN_WORKLOAD
SERVE_WL = PAPER_SERVE_WORKLOAD


# -- the paper's Table-3 settings ----------------------------------------------
register(Scenario(
    name="smart_home_1",
    description="Paper Table 3: well-provisioned smart home — 2 gaming "
                "laptops + 3 mini-PC dGPUs on 900 Mbps WiFi, fine-tuning.",
    topology=lambda: make_setting("smart_home_1"),
    model="qwen3-0.6b", workload=TRAIN_WL,
    qoe=QoESpec(t_qoe=6.0, lam=50.0),
    tags=("paper", "train"),
    request_rate=0.08,
))

register(Scenario(
    name="smart_home_2",
    description="Paper Table 3: mixed smart home — 2 laptop dGPUs + 3 "
                "phones on 600 Mbps WiFi, fine-tuning under a latency "
                "target.",
    topology=lambda: make_setting("smart_home_2"),
    model="qwen3-0.6b", workload=TRAIN_WL,
    qoe=QoESpec(t_qoe=8.0, lam=50.0),
    tags=("paper", "train"),
    request_rate=0.04,
    timeline=(
        ("evening 4K stream saturates WiFi (-50%)",
         DynamicsEvent(t=30.0, bandwidth_scale={"wifi": 0.5})),
        ("phone 4 unplugged, leaves the fleet",
         DynamicsEvent(t=60.0, leave=(4,))),
        ("stream ends",
         DynamicsEvent(t=150.0, bandwidth_scale={"wifi": 1.0})),
        ("phone 4 back on the charger, rejoins",
         DynamicsEvent(t=1200.0, join=(4,))),
    ),
))

register(Scenario(
    name="traffic_monitor",
    description="Paper Table 3: roadside camera fleet — 4 Genio boards "
                "on a wired ring + shared WiFi, per-token serving.",
    topology=lambda: make_setting("traffic_monitor"),
    model="qwen3-0.6b", workload=SERVE_WL,
    qoe=QoESpec(t_qoe=0.2, lam=100.0),
    tags=("paper", "serve"),
    request_rate=3.0,
    timeline=(
        ("camera 3 powers down for maintenance",
         DynamicsEvent(t=20.0, leave=(3,))),
        ("camera 3 back online",
         DynamicsEvent(t=60.0, join=(3,))),
    ),
))

register(Scenario(
    name="edge_cluster",
    description="Paper Table 3: small edge cluster — 2×A40 + 2×V100 on a "
                "4 Gbps wired LAN ring, fine-tuning a larger model.",
    topology=lambda: make_setting("edge_cluster"),
    model="qwen3-1.7b", workload=TRAIN_WL,
    qoe=QoESpec(t_qoe=2.0, lam=50.0),
    tags=("paper", "train"),
    request_rate=0.2,
))


# -- new deployments ------------------------------------------------------------
def _retail_topology() -> Topology:
    """RTX back-office server + two camera-hub Genio boards + one shelf
    gateway. Everyone is on store WiFi; the server additionally has
    dedicated ethernet to the camera hubs. The server is device 0 (the
    partitioner's DP grows plans over device prefixes)."""
    c = CATALOG
    devs = [c["rtx4060"], c["genio720"], c["genio720"], c["genio520"]]
    wifi = LinkResource("wifi", 600.0 * MBPS, frozenset(range(4)),
                        shared=True, latency=3e-3)
    eth = [LinkResource(f"eth-0-{i}", 1000.0 * MBPS, frozenset((0, i)),
                        shared=False, latency=0.3e-3) for i in (1, 2)]
    p2p = {}
    for i in (1, 2):
        p2p[(0, i)] = [f"eth-0-{i}"]
        p2p[(i, 0)] = [f"eth-0-{i}"]
    return Topology.mixed(devs, [wifi] + eth, p2p)


register(Scenario(
    name="retail_analytics",
    description="Retail-camera analytics: 2 camera hubs + shelf gateway "
                "on store WiFi, RTX back-office server on ethernet; "
                "serving shopper-flow queries.",
    topology=_retail_topology,
    model="qwen3-0.6b", workload=SERVE_WL,
    qoe=QoESpec(t_qoe=0.25, lam=100.0),
    tags=("serve", "mixed-network"),
    request_rate=3.0,
    timeline=(
        ("checkout rush saturates store WiFi (-60%)",
         DynamicsEvent(t=30.0, bandwidth_scale={"wifi": 0.4})),
        ("rush clears",
         DynamicsEvent(t=120.0, bandwidth_scale={"wifi": 1.0})),
    ),
))


def _hospital_topology() -> Topology:
    """Bedside tablets + two ward gateways on hospital WiFi (data must
    stay on-prem, so the fleet is all there is)."""
    c = CATALOG
    devs = [c["s25"], c["s25"], c["s25"], c["s25"],
            c["genio720"], c["genio720"]]
    return Topology.shared_medium(devs, 300.0, latency=4e-3)


register(Scenario(
    name="hospital_ward",
    description="Hospital ward monitoring: 4 bedside tablets + 2 "
                "gateways on 300 Mbps WiFi; on-prem serving with a "
                "strict alarm-latency target.",
    topology=_hospital_topology,
    model="qwen3-0.6b", workload=SERVE_WL,
    qoe=QoESpec(t_qoe=0.3, e_qoe=5.0, lam=200.0),
    tags=("serve", "energy-budget"),
    request_rate=3.0,
))


def _platoon_topology() -> Topology:
    """Four vehicles in convoy: V2V side links form a ring; hops are
    slow (100 Mbps) and high-latency (5 ms MAC/retry budget)."""
    devs = [CATALOG["genio520"]] * 4
    return Topology.ring(devs, 100.0, name="v2v", latency=5e-3)


register(Scenario(
    name="vehicle_platoon",
    description="Vehicle platoon: 4 in-car Genio boards over lossy "
                "100 Mbps V2V links; cooperative perception serving.",
    topology=_platoon_topology,
    model="bert", workload=SERVE_WL,
    qoe=QoESpec(t_qoe=0.25, lam=100.0),
    tags=("serve", "lossy-network"),
    request_rate=10.0,
    timeline=(
        ("overtaking truck shadows V2V links (-50%)",
         DynamicsEvent(t=15.0, bandwidth_scale={
             "v2v-0-1": 0.5, "v2v-1-2": 0.5, "v2v-2-3": 0.5,
             "v2v-3-0": 0.5})),
        ("truck passes",
         DynamicsEvent(t=45.0, bandwidth_scale={
             "v2v-0-1": 1.0, "v2v-1-2": 1.0, "v2v-2-3": 1.0,
             "v2v-3-0": 1.0})),
    ),
))


def _degraded_home_topology() -> Topology:
    """Smart Home 2's fleet with the phones on battery saver: thermal +
    battery governors cap sustained compute at ~60% of peak."""
    c = CATALOG
    throttle = lambda d: dataclasses.replace(d, flops=d.flops * 0.6)
    devs = [c["rtx4050"], c["rtx4050"],
            throttle(c["mi15"]), throttle(c["mi15"]), throttle(c["s25"])]
    return Topology.shared_medium(devs, 600.0)


# e_qoe calibration: the fleet's best plan costs ~270 J/device-iteration
# (11.8 s iterations × dGPU idle+compute draw), so the budget sits just
# above the healthy-plan envelope — bad plans (or refusing to shed the
# throttled phone) blow it, good ones do not.
register(Scenario(
    name="smart_home_degraded",
    description="Battery-degraded smart home: Smart Home 2 with phones "
                "throttled to 60% and a hard per-device energy budget; "
                "overnight fine-tuning.",
    topology=_degraded_home_topology,
    model="qwen3-0.6b", workload=TRAIN_WL,
    qoe=QoESpec(t_qoe=12.0, e_qoe=400.0, lam=20.0, deadline=8 * 3600.0),
    tags=("train", "energy-budget"),
    request_rate=0.02,
    timeline=(
        ("phone 4 hits battery saver (compute -50%)",
         DynamicsEvent(t=60.0, compute_speed={4: 0.5})),
        ("4K stream on home WiFi (-40%)",
         DynamicsEvent(t=180.0, bandwidth_scale={"wifi": 0.6})),
        ("stream ends",
         DynamicsEvent(t=600.0, bandwidth_scale={"wifi": 1.0})),
        ("phone 4 off battery saver",
         DynamicsEvent(t=900.0, compute_speed={4: 1.0})),
    ),
))


def _v5e_pod_topology() -> Topology:
    """A 4-chip TPU v5e ring for pod-level planning (the hardware
    target of the JAX package's substrate): ICI-class 50 GB/s links."""
    devs = [CATALOG["v5e"]] * 4
    return Topology.ring(devs, 400000.0, name="ici", latency=0.05e-3)


register(Scenario(
    name="edge_pod_v5e",
    description="TPU v5e pod slice: 4 chips on ICI-class links; Dora "
                "plans the same graph it partitions for edge fleets.",
    topology=_v5e_pod_topology,
    model="qwen3-1.7b", workload=TRAIN_WL,
    qoe=QoESpec(t_qoe=0.8, lam=50.0),
    tags=("train", "pod"),
    request_rate=0.4,
))


# -- trace-driven arrival scenarios --------------------------------------------
# Serving deployments whose load is *not* a flat Poisson stream: the
# serving kernel's arrival zoo (``repro_torch.core.events``) modulates the
# registered mean rate, and multi-class tiers judge each request
# against its own SLO.  ``dora.simulate(..., mode="requests")`` picks
# both up automatically.
register(Scenario(
    name="transit_hub",
    description="Transit-station kiosks: commuter queries swing through "
                "a rush-hour cycle; an interactive rider tier rides "
                "alongside a lax batch analytics tier.",
    topology=lambda: make_setting("traffic_monitor"),
    model="qwen3-0.6b", workload=SERVE_WL,
    qoe=QoESpec(t_qoe=0.3, lam=100.0),
    tags=("serve", "trace-driven"),
    request_rate=4.0,
    arrival=DiurnalArrivals(period_s=240.0, amplitude=0.9),
    request_classes=interactive_batch(0.25, 2.0, interactive_share=0.75),
))

register(Scenario(
    name="stadium_gate",
    description="Stadium-entrance screening: steady trickle until the "
                "gates open, then a flash crowd 8x the baseline slams "
                "the fleet for a minute.",
    topology=lambda: make_setting("traffic_monitor"),
    model="qwen3-0.6b", workload=SERVE_WL,
    qoe=QoESpec(t_qoe=0.4, lam=100.0),
    tags=("serve", "trace-driven"),
    request_rate=2.0,
    arrival=FlashCrowdArrivals(peak_multiplier=8.0, t_start=30.0,
                               ramp_s=10.0, hold_s=60.0),
))


# -- generated-family representatives ------------------------------------------
# ``repro_torch.scenarios.generate`` samples whole *families* of deployments;
# the catalog pins one named representative per new family so the
# list/plan/simulate surfaces (and the strategy matrix tests) always
# exercise them.  The seeds are verified: Dora meets the sampled QoE,
# the dynamics timeline ends QoE-ok, and every registered strategy
# produces a valid plan.  Reproduce either one with
# ``generate("vehicle_platoon", 2)`` / ``generate("lossy_mesh", 24)``.
from .generate import register_generated  # noqa: E402  (cycle-safe)

register_generated(
    "vehicle_platoon", seed=2, name="platoon_convoy",
    description="Generated convoy: four vehicles on a lossy V2V ring "
                "whose link quality is redrawn by mobility events; "
                "per-token serving under churn (vehicle_platoon family, "
                "seed 2).")

register_generated(
    "lossy_mesh", seed=24, name="lossy_mesh",
    description="Generated degraded mesh: four boards on a partial 5G "
                "mesh with a thermal throttle and repeated bandwidth "
                "dips (lossy_mesh family, seed 24).")

register_generated(
    "battery_constrained", seed=12, name="battery_constrained",
    description="Generated battery-constrained fleet: six devices on a "
                "shared home medium, four running off finite batteries "
                "the serving load drains mid-horizon — exercises the "
                "control plane's SoC tracking and pre-death evacuation "
                "(battery_constrained family, seed 12).")

register_generated(
    "faulty_sites", seed=16, name="faulty_sites",
    description="Generated chaos site: seven devices on a partial "
                "wifi mesh whose timeline carries unannounced "
                "crash-stops, a link flap and a silent straggler — "
                "request-mode simulation routes through the "
                "resilience engine (faulty_sites family, seed 16).")
