# A copy of src/repro/fleet/catalog.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's fleet plans must match the reference's to the last bit.
"""Built-in multi-tenant fleet scenarios.

Each fleet reuses a Table-3 device setting and co-locates two tenant
workloads on it.  Tenant ``topology`` fields point at the *same* shared
fleet builder, so ``dora.plan(tenant)`` standalone reproduces exactly
the "independent planning on the full fleet" baseline that
``benchmarks/fig_fleet.py`` compares against: without co-planning,
every tenant independently picks the same energy-optimal device and
they grind each other's QoE down once the fluid-fair interference is
priced.
"""
from __future__ import annotations

from ..core.adapter import DynamicsEvent
from ..core.cost_model import PAPER_SERVE_WORKLOAD, PAPER_TRAIN_WORKLOAD
from ..core.device import make_setting
from ..core.qoe import QoESpec
from ..scenarios import Scenario
from . import FleetScenario, register_fleet


def _home2():
    return make_setting("smart_home_2")


def _traffic():
    return make_setting("traffic_monitor")


def _home1():
    return make_setting("smart_home_1")


# -- smart home: voice assistant + door-camera vision --------------------------
VOICE_ASSISTANT = Scenario(
    name="voice_assistant",
    description="Always-on voice assistant serving household queries.",
    topology=_home2, model="qwen3-0.6b", workload=PAPER_SERVE_WORKLOAD,
    qoe=QoESpec(t_qoe=0.3, lam=100.0), tags=("serve", "tenant"),
    request_rate=2.0)

VISION_MONITOR = Scenario(
    name="vision_monitor",
    description="Door-camera vision encoder flagging motion events.",
    topology=_home2, model="bert", workload=PAPER_SERVE_WORKLOAD,
    qoe=QoESpec(t_qoe=0.05, lam=100.0), tags=("serve", "tenant"),
    request_rate=5.0)

register_fleet(FleetScenario(
    name="smart_home_assist",
    description="Smart Home 2 fleet shared by a voice assistant and a "
                "vision monitor; both gravitate to the same phone when "
                "planned independently.",
    topology=_home2, tenants=(VOICE_ASSISTANT, VISION_MONITOR),
    tags=("fleet", "serve"),
    timeline=(
        ("evening 4K stream saturates WiFi (-40%)",
         DynamicsEvent(t=30.0, bandwidth_scale={"wifi": 0.6})),
        ("stream ends",
         DynamicsEvent(t=90.0, bandwidth_scale={"wifi": 1.0})),
    ),
))


# -- roadside unit: detector + tracker ------------------------------------------
DETECTOR = Scenario(
    name="detector",
    description="Per-frame object detector on the roadside camera feed.",
    topology=_traffic, model="qwen3-0.6b", workload=PAPER_SERVE_WORKLOAD,
    qoe=QoESpec(t_qoe=0.2, lam=100.0), tags=("serve", "tenant"),
    request_rate=3.0)

TRACKER = Scenario(
    name="tracker",
    description="Lightweight track-association model over detections.",
    topology=_traffic, model="bert", workload=PAPER_SERVE_WORKLOAD,
    qoe=QoESpec(t_qoe=0.05, lam=100.0), tags=("serve", "tenant"),
    request_rate=6.0)

register_fleet(FleetScenario(
    name="traffic_intersection",
    description="Traffic-monitor fleet running detector + tracker; "
                "camera churn and a thermal throttle force the "
                "rebalancer to shuffle devices between tenants.",
    topology=_traffic, tenants=(DETECTOR, TRACKER),
    tags=("fleet", "serve"),
    timeline=(
        ("camera 3 powers down for maintenance",
         DynamicsEvent(t=20.0, leave=(3,))),
        ("midday heat throttles camera 0 (-40%)",
         DynamicsEvent(t=35.0, compute_speed={0: 0.6})),
        ("camera 3 back online",
         DynamicsEvent(t=60.0, join=(3,))),
        ("camera 0 cools off",
         DynamicsEvent(t=80.0, compute_speed={0: 1.0})),
    ),
))


# -- smart home at night: fine-tune + assistant ----------------------------------
OVERNIGHT_TUNE = Scenario(
    name="overnight_tune",
    description="Overnight fine-tuning run pacing toward a morning "
                "deadline.",
    topology=_home1, model="qwen3-0.6b", workload=PAPER_TRAIN_WORKLOAD,
    qoe=QoESpec(t_qoe=6.0, lam=50.0, deadline=8 * 3600.0),
    tags=("train", "tenant"), request_rate=0.05)

NIGHT_ASSISTANT = Scenario(
    name="night_assistant",
    description="Low-traffic voice assistant that must stay snappy "
                "while the fleet fine-tunes.",
    topology=_home1, model="qwen3-0.6b", workload=PAPER_SERVE_WORKLOAD,
    qoe=QoESpec(t_qoe=0.08, lam=100.0), tags=("serve", "tenant"),
    request_rate=1.0)

register_fleet(FleetScenario(
    name="smart_home_overnight",
    description="Smart Home 1 fleet fine-tuning overnight while still "
                "serving the assistant: a train + serve tenant mix.",
    topology=_home1, tenants=(OVERNIGHT_TUNE, NIGHT_ASSISTANT),
    tags=("fleet", "mixed"),
    timeline=(
        ("late-night 4K stream (-50% WiFi)",
         DynamicsEvent(t=40.0, bandwidth_scale={"wifi": 0.5})),
        ("stream ends",
         DynamicsEvent(t=120.0, bandwidth_scale={"wifi": 1.0})),
    ),
))


# -- generated mixed fleet --------------------------------------------------------
# One representative of the generator's ``mixed_train_serve`` fleet
# family (repro_torch.scenarios.generate.generate_fleet): a fine-tuning
# tenant co-deployed with an always-on serving tenant on a generated
# shared-medium fleet.  Seed 0 is verified feasible under co-planning.
from ..scenarios.generate import generate_fleet

register_fleet(generate_fleet(0, name="mixed_train_serve"))
