# A copy of src/repro/scenarios/generate.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port must plan the reference's deployments, field for field.
"""Seeded, parameterized scenario generator — thousands of deployments
from a dozen hand-built ones.

The catalog (``repro_torch.scenarios.catalog``) hand-wires nine deployments;
Dora's QoE claims live in a far larger space of fleets, networks and
runtime dynamics.  This module samples that space *deterministically*:

    from repro_torch.scenarios.generate import generate
    sc = generate("lossy_mesh", seed=7)      # a valid Scenario
    report = dora.plan(sc)

Every scenario is fully determined by ``(family, seed)`` — the same
pair always yields a byte-identical parameter summary (locked by
``tests/golden/scenario_gen_golden.json``), so a falsified property
test names a reproducible deployment.

A **family** bundles the distributions one deployment archetype is
drawn from: topology families (star / ring / mesh / multi-hop / shared
medium), link technologies (wifi / 5G / ethernet / V2V with
bandwidth + latency envelopes), device classes from
``core.device.CATALOG``, battery/thermal-throttle models, dynamics
timelines (churn, bandwidth dips, load shifts) and workload mixes.
Built-in families:

========================  ====================================================
``edge_sites``            generic heterogeneous edge sites over all four
                          structured topology families
``smart_home``            phones + consumer dGPUs on one shared medium
``vehicle_platoon``       convoy mobility: lossy V2V chains/rings with
                          *time-varying* link quality (DistrEdge-style)
``lossy_mesh``            degraded partial meshes: low-bandwidth, high-latency
                          links that keep dropping further (DEFER-style)
``faulty_sites``          chaos archetype: edge sites under *unannounced*
                          failures — crash-stop devices, link flaps and
                          silent stragglers (see :mod:`repro_torch.resilience`)
``battery_constrained``   battery-powered fleets: finite per-device energy
                          stores (``DeviceProfile.battery_j``) the serving
                          load drains (see :mod:`repro_torch.control.battery`)
``mixed_train_serve``     fleet family: a fine-tuning tenant co-deployed with
                          serving tenants (see :func:`generate_fleet`)
========================  ====================================================

Generated scenarios are plain :class:`~repro_torch.scenarios.Scenario`
objects; :func:`register_generated` pushes one into the global registry
through the normal ``register`` idiom (the catalog registers one named
representative per new family).  Topology factories build a *fresh*
``Topology`` per call — see ``Scenario.build_topology``'s fresh-copy
contract.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.adapter import DynamicsEvent
from ..core.cost_model import Workload
from ..core.device import CATALOG, DeviceProfile, Topology
from ..core.graph_builders import GraphSpec, build_lm_graph, paper_model
from ..core.planning_graph import ModelGraph
from ..core.qoe import QoESpec
from . import Scenario, register

__all__ = [
    "LinkTech", "FamilySpec", "ScenarioParams", "LINK_TECHS",
    "DEVICE_CLASSES", "FAMILIES", "TOPOLOGY_FAMILIES", "list_families",
    "sample_params", "scenario_from_params", "generate", "generate_many",
    "register_generated", "generate_fleet", "summarize",
]


# -- building blocks ------------------------------------------------------------
#: Topology families the generator composes (the "shared" family is one
#: shared medium; the other four are structured dedicated-link fabrics).
TOPOLOGY_FAMILIES = ("star", "ring", "mesh", "multi_hop", "shared")


@dataclasses.dataclass(frozen=True)
class LinkTech:
    """One link technology: bandwidth/latency envelopes + jitter depth.

    ``mbps``/``latency_s`` bound the uniform draw for a deployment's
    links; ``dip`` bounds how deep this technology's bandwidth dips go
    in generated dynamics timelines (0.6 = drops to 40% of nominal).
    """

    name: str
    mbps: Tuple[float, float]
    latency_s: Tuple[float, float]
    shared: bool                      # can form a shared medium
    dip: Tuple[float, float]


LINK_TECHS: Dict[str, LinkTech] = {
    "wifi": LinkTech("wifi", (150.0, 900.0), (2e-3, 5e-3), True, (0.3, 0.6)),
    "5g": LinkTech("5g", (80.0, 400.0), (8e-3, 20e-3), True, (0.4, 0.7)),
    "ethernet": LinkTech("ethernet", (1000.0, 4000.0), (1e-4, 5e-4), False,
                         (0.0, 0.2)),
    "v2v": LinkTech("v2v", (40.0, 150.0), (4e-3, 10e-3), False, (0.4, 0.8)),
}

#: Device classes over ``core.device.CATALOG`` profiles.
DEVICE_CLASSES: Dict[str, Tuple[str, ...]] = {
    "phone": ("s25", "mi15"),
    "board": ("genio520", "genio720"),
    "dgpu": ("rtx4050", "rtx4060", "rtx4060ti"),
    "server": ("v100", "a40"),
}

# -- models the generator can draw ----------------------------------------------
# Tiny planning graphs keep property-test sweeps at ~ms per plan; the
# builders are module-level named functions so ``Scenario.model_name``
# (and the golden summaries) stay stable.
_TINY_SPECS: Dict[str, GraphSpec] = {
    "tiny_lm_4": GraphSpec("tiny_lm_4", 4, 64, 4, 2, 192, 1000, seq_len=64,
                           gated_mlp=False),
    "tiny_lm_8": GraphSpec("tiny_lm_8", 8, 128, 4, 2, 384, 2000, seq_len=64),
}


def tiny_lm_4(seq_len: int) -> ModelGraph:
    return build_lm_graph(_TINY_SPECS["tiny_lm_4"], seq_len=seq_len)


def tiny_lm_8(seq_len: int) -> ModelGraph:
    return build_lm_graph(_TINY_SPECS["tiny_lm_8"], seq_len=seq_len)


_MODEL_BUILDERS: Dict[str, Callable[[int], ModelGraph]] = {
    "tiny_lm_4": tiny_lm_4,
    "tiny_lm_8": tiny_lm_8,
}


def _model_ref(name: str):
    """A ``Scenario.model`` value for ``name`` (paper name or tiny)."""
    return _MODEL_BUILDERS.get(name, name)


def _model_graph(name: str, seq_len: int) -> ModelGraph:
    if name in _MODEL_BUILDERS:
        return _MODEL_BUILDERS[name](seq_len)
    return paper_model(name, seq_len=seq_len)


# param bytes per model (cached; drives the memory-feasibility filter)
_PARAM_BYTES: Dict[str, float] = {}


def _model_param_bytes(name: str) -> float:
    if name not in _PARAM_BYTES:
        _PARAM_BYTES[name] = _model_graph(name, 32).total_params
    return _PARAM_BYTES[name]


# -- family specifications ------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Parameter distributions for one deployment archetype."""

    name: str
    description: str
    topologies: Tuple[str, ...]
    techs: Tuple[str, ...]
    device_classes: Tuple[str, ...]
    n_devices: Tuple[int, int]
    modes: Tuple[str, ...]                # "train" / "serve"
    models: Tuple[str, ...]
    #: t_qoe = (ideal aggregate-compute latency) × slack drawn from here
    qoe_slack: Tuple[float, float] = (1.5, 6.0)
    #: probability the QoE carries a per-device energy budget
    energy_budget_p: float = 0.3
    #: probability any one device is battery/thermal-throttled (its
    #: sustained FLOP/s capped at 50-80% of peak via the device profile)
    throttle_p: float = 0.15
    #: dynamics-event kinds the timeline is composed from
    dynamics: Tuple[str, ...] = ("bw_dip", "throttle", "churn")
    max_events: int = 3
    #: probability any one device runs on battery (a finite
    #: ``DeviceProfile.battery_j`` store the serving kernel's energy
    #: attribution drains — see ``repro_torch.control.battery``)
    battery_p: float = 0.0
    #: battery capacity drawn as seconds of the device's own idle draw,
    #: so deaths land within simulated horizons regardless of class
    battery_idle_s: Tuple[float, float] = (120.0, 900.0)


FAMILIES: Dict[str, FamilySpec] = {}


def _family(spec: FamilySpec) -> FamilySpec:
    if spec.name in FAMILIES:
        raise ValueError(f"generator family {spec.name!r} already defined")
    FAMILIES[spec.name] = spec
    return spec


_family(FamilySpec(
    name="edge_sites",
    description="Generic heterogeneous edge sites: boards/dGPUs/servers "
                "on structured fabrics (star, ring, mesh, multi-hop).",
    topologies=("star", "ring", "mesh", "multi_hop"),
    techs=("ethernet", "wifi", "5g"),
    device_classes=("board", "dgpu", "server"),
    n_devices=(2, 8), modes=("train", "serve"),
    models=("bert", "qwen3-0.6b", "tiny_lm_8"),
))

_family(FamilySpec(
    name="smart_home",
    description="Phones + consumer dGPUs on one shared home medium; "
                "battery-saver throttles and evening-stream WiFi dips.",
    topologies=("shared",),
    techs=("wifi", "5g"),
    device_classes=("phone", "dgpu"),
    n_devices=(2, 6), modes=("train", "serve"),
    models=("bert", "qwen3-0.6b", "tiny_lm_8"),
    energy_budget_p=0.5, throttle_p=0.35,
    dynamics=("bw_dip", "throttle", "churn"),
))

_family(FamilySpec(
    name="vehicle_platoon",
    description="Convoy mobility: in-vehicle boards over lossy V2V "
                "chains/rings whose link quality varies continuously "
                "as the platoon stretches and closes up.",
    topologies=("multi_hop", "ring"),
    techs=("v2v",),
    device_classes=("board", "phone"),
    n_devices=(3, 6), modes=("serve",),
    models=("bert", "tiny_lm_8", "tiny_lm_4"),
    qoe_slack=(2.0, 8.0),
    dynamics=("mobility", "churn"),
    max_events=6,
))

_family(FamilySpec(
    name="faulty_sites",
    description="Chaos archetype: heterogeneous edge sites whose "
                "devices crash-stop silently, links flap and "
                "stragglers slow down without announcing it — the "
                "resilience layer's native habitat.",
    topologies=("star", "mesh", "ring"),
    techs=("wifi", "5g", "ethernet"),
    device_classes=("board", "dgpu", "server"),
    n_devices=(3, 7), modes=("serve",),
    models=("bert", "tiny_lm_8", "tiny_lm_4"),
    qoe_slack=(2.0, 8.0),
    dynamics=("crash", "link_flap", "straggler", "bw_dip"),
    max_events=4,
))

_family(FamilySpec(
    name="lossy_mesh",
    description="Degraded partial meshes: low-bandwidth high-latency "
                "links that keep losing capacity; traffic reroutes "
                "multi-hop around the damage.",
    topologies=("mesh",),
    techs=("v2v", "5g", "wifi"),
    device_classes=("board", "dgpu"),
    n_devices=(3, 7), modes=("serve", "train"),
    models=("bert", "tiny_lm_8"),
    qoe_slack=(2.0, 8.0),
    dynamics=("bw_dip", "churn"),
    max_events=4,
))


_family(FamilySpec(
    name="battery_constrained",
    description="Battery-powered fleets: phones and boards serving off "
                "finite energy stores the request load drains — the "
                "control plane's SoC mechanisms' native habitat.",
    topologies=("shared", "star"),
    techs=("wifi", "5g"),
    device_classes=("phone", "board", "dgpu"),
    n_devices=(3, 6), modes=("serve",),
    models=("bert", "tiny_lm_8", "tiny_lm_4"),
    qoe_slack=(2.0, 8.0),
    energy_budget_p=0.5,
    dynamics=("bw_dip", "throttle"),
    max_events=2,
    battery_p=0.5,
    battery_idle_s=(45.0, 240.0),
))


def list_families() -> List[str]:
    """Names of all generator families, sorted."""
    return sorted(FAMILIES)


# -- sampled parameter bundle ---------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """Everything :func:`generate` sampled for one ``(family, seed)``.

    Frozen and fully value-typed: two identical ``ScenarioParams`` build
    byte-identical scenarios, and :meth:`summary` is the canonical
    (golden-locked) serialization of the draw.
    """

    family: str
    seed: int
    topology_family: str
    tech: str
    device_names: Tuple[str, ...]
    throttles: Tuple[Tuple[int, float], ...]      # (device, sustained factor)
    link_mbps: float
    link_latency_s: float
    edges: Tuple[Tuple[int, int], ...]            # () for shared/derived fabrics
    model: str
    mode: str
    seq_len: int
    global_batch: int
    microbatch_size: int
    optimizer_mult: float
    t_qoe: float
    e_qoe: Optional[float]
    lam: float
    request_rate: float
    events: Tuple[Tuple[str, float, str, float], ...]
    # ^ (kind, t, target, value): kind in bw_dip/throttle/churn_leave/
    #   churn_join/mobility plus the unannounced fault kinds
    #   crash/link_down/link_up/straggler; target is a resource name
    #   or device index
    #: battery-backed devices as (device, capacity joules); empty for
    #: wall-powered fleets — drawn last so pre-battery families keep
    #: byte-identical summaries
    batteries: Tuple[Tuple[int, float], ...] = ()

    @property
    def name(self) -> str:
        return f"gen/{self.family}/{self.seed:04d}"

    def summary(self) -> str:
        """Canonical one-line serialization (byte-stable per seed)."""
        g6 = lambda x: format(x, ".6g")  # noqa: E731
        thr = ",".join(f"{d}:{g6(f)}" for d, f in self.throttles) or "-"
        edges = ",".join(f"{a}-{b}" for a, b in self.edges) or "-"
        evs = ";".join(f"{k}@{g6(t)}:{tgt}={g6(v)}"
                       for k, t, tgt, v in self.events) or "-"
        # only battery-drawing families carry the segment: pre-battery
        # summaries must stay byte-identical
        batt = ("" if not self.batteries else
                " batt=" + ",".join(f"{d}:{g6(j)}"
                                    for d, j in self.batteries))
        return (f"{self.name} topo={self.topology_family} tech={self.tech} "
                f"devs=[{','.join(self.device_names)}] throttle={thr} "
                f"link={g6(self.link_mbps)}Mbps/{g6(self.link_latency_s * 1e3)}ms "
                f"edges={edges} model={self.model} mode={self.mode} "
                f"seq={self.seq_len} wl=gb{self.global_batch}/"
                f"mb{self.microbatch_size}/om{g6(self.optimizer_mult)} "
                f"qoe=t{g6(self.t_qoe)}/"
                f"e{g6(self.e_qoe) if self.e_qoe is not None else 'None'}/"
                f"lam{g6(self.lam)} rate={g6(self.request_rate)} "
                f"events={evs}{batt}")

    # -- builders -------------------------------------------------------------
    def devices(self) -> List[DeviceProfile]:
        devs = [CATALOG[n] for n in self.device_names]
        for d, f in self.throttles:
            devs[d] = dataclasses.replace(devs[d], flops=devs[d].flops * f)
        for d, j in self.batteries:
            devs[d] = dataclasses.replace(devs[d], battery_j=j)
        return devs

    def build_topology(self) -> Topology:
        """A fresh ``Topology`` (never cached — every call re-builds, per
        the ``Scenario.build_topology`` fresh-copy contract)."""
        devs = self.devices()
        fam, mbps, lat = self.topology_family, self.link_mbps, self.link_latency_s
        if fam == "shared":
            return Topology.shared_medium(devs, mbps, name=self.tech,
                                          latency=lat)
        name = self.tech
        if fam == "star":
            return Topology.star(devs, mbps, name=name, latency=lat)
        if fam == "ring":
            return Topology.ring(devs, mbps, name=name, latency=lat)
        if fam == "multi_hop":
            return Topology.line(devs, mbps, name=name, latency=lat)
        if fam == "mesh":
            return Topology.mesh(devs, mbps, name=name, latency=lat,
                                 edges=self.edges or None)
        raise ValueError(f"unknown topology family {fam!r}")

    def timeline(self) -> Tuple[Tuple[str, DynamicsEvent], ...]:
        out: List[Tuple[str, DynamicsEvent]] = []
        for kind, t, target, value in self.events:
            if kind in ("bw_dip", "mobility"):
                label = (f"{kind}: {target} -> x{format(value, '.3g')}")
                ev = DynamicsEvent(t=t, bandwidth_scale={target: value})
            elif kind == "throttle":
                label = (f"throttle: device {target} -> "
                         f"x{format(value, '.3g')}")
                ev = DynamicsEvent(t=t, compute_speed={int(target): value})
            elif kind == "churn_leave":
                label = f"churn: device {target} leaves"
                ev = DynamicsEvent(t=t, leave=(int(target),))
            elif kind == "churn_join":
                label = f"churn: device {target} rejoins"
                ev = DynamicsEvent(t=t, join=(int(target),))
            elif kind == "crash":
                label = f"crash: device {target}"
                ev = DynamicsEvent(t=t, crash=(int(target),))
            elif kind == "link_down":
                label = f"link down: {target}"
                ev = DynamicsEvent(t=t, link_down=(target,))
            elif kind == "link_up":
                label = f"link up: {target}"
                ev = DynamicsEvent(t=t, link_up=(target,))
            elif kind == "straggler":
                label = (f"straggler: device {target} -> "
                         f"x{format(value, '.3g')}")
                ev = DynamicsEvent(t=t, straggler={int(target): value})
            else:
                raise ValueError(f"unknown event kind {kind!r}")
            out.append((label, ev))
        return tuple(out)


# -- sampling -------------------------------------------------------------------
def _rng(family: str, seed: int) -> random.Random:
    # string seeding hashes via sha512 — stable across processes and
    # platforms, unaffected by PYTHONHASHSEED
    return random.Random(f"dora-gen:{family}:{seed}")


def _ring_link(name: str, i: int, n: int) -> str:
    return f"{name}-{i}-{(i + 1) % n}"


def _resource_names(topology_family: str, tech: str, n: int,
                    edges: Sequence[Tuple[int, int]]) -> List[str]:
    """Names of the link resources the built topology will expose (for
    sampling dynamics targets without building the topology)."""
    if topology_family == "shared":
        return [tech]
    if topology_family == "ring":
        return [_ring_link(tech, i, n) for i in range(n)]
    if topology_family == "star":
        return [f"{tech}-0-{i}" for i in range(1, n)]
    if topology_family == "multi_hop":
        return [f"{tech}-{i}-{i + 1}" for i in range(n - 1)]
    return [f"{tech}-{min(a, b)}-{max(a, b)}" for a, b in edges]


def _sample_mesh_edges(rng: random.Random, n: int
                       ) -> Tuple[Tuple[int, int], ...]:
    """A connected partial mesh: a random spanning tree plus a sampled
    fraction of the remaining pairs."""
    order = list(range(1, n))
    rng.shuffle(order)
    edges = set()
    connected = [0]
    for v in order:
        u = rng.choice(connected)
        edges.add((min(u, v), max(u, v)))
        connected.append(v)
    extra_p = rng.uniform(0.15, 0.6)
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) not in edges and rng.random() < extra_p:
                edges.add((i, j))
    return tuple(sorted(edges))


def _churn_candidates(params_devices: int, topology_family: str,
                      edges: Sequence[Tuple[int, int]]) -> List[int]:
    """Devices whose departure keeps the fleet connected (device 0 — the
    hub / DP anchor — never churns)."""
    n = params_devices
    if n <= 2:
        return []
    if topology_family in ("shared", "mesh", "ring"):
        # shared medium / ring reroute always survive one departure;
        # mesh connectivity must be checked against the edge list
        if topology_family != "mesh":
            return list(range(1, n))
        out = []
        for d in range(1, n):
            adj: Dict[int, Dict[int, str]] = {}
            for a, b in edges:
                if d in (a, b):
                    continue
                adj.setdefault(a, {})[b] = "x"
                adj.setdefault(b, {})[a] = "x"
            rest = [v for v in range(n) if v != d]
            seen = {rest[0]}
            frontier = [rest[0]]
            while frontier:
                nxt = []
                for a in frontier:
                    for b in adj.get(a, {}):
                        if b not in seen:
                            seen.add(b)
                            nxt.append(b)
                frontier = nxt
            if set(rest) <= seen:
                out.append(d)
        return out
    if topology_family == "multi_hop":
        return [n - 1]          # only the tail is removable
    if topology_family == "star":
        return list(range(1, n))  # any leaf (never the hub)
    return []


def _ideal_latency(devs: Sequence[DeviceProfile], model: str, mode: str,
                   seq_len: int, n_micro: int,
                   link_mbps: float = 1000.0,
                   link_latency_s: float = 1e-3) -> float:
    """Optimistic-but-honest latency anchor the sampled QoE slack
    multiplies: aggregate-compute lower bound plus a two-hop network
    floor (one boundary activation each way) — per-token serving is
    dominated by the latter on edge links."""
    g = _model_graph(model, seq_len if mode == "train" else 1)
    flops = sum(n.flops_fwd for n in g.nodes)
    if mode == "train":
        flops = 3.0 * flops * n_micro
    agg = sum(d.effective_flops() for d in devs)
    act = max(n.act_bytes for n in g.nodes)
    from ..core.device import MBPS
    hop = link_latency_s + act / (link_mbps * MBPS)
    return flops / agg + 2.0 * hop * (n_micro if mode == "train" else 1.0)


def sample_params(family: str, seed: int) -> ScenarioParams:
    """Draw one deterministic parameter bundle for ``(family, seed)``."""
    try:
        spec = FAMILIES[family]
    except KeyError:
        known = ", ".join(sorted(FAMILIES))
        raise KeyError(f"unknown generator family {family!r}; "
                       f"known: {known}") from None
    rng = _rng(family, seed)

    topology_family = rng.choice(spec.topologies)
    tech = rng.choice([t for t in spec.techs
                       if topology_family != "shared"
                       or LINK_TECHS[t].shared])
    lt = LINK_TECHS[tech]
    n = rng.randint(*spec.n_devices)
    classes = [rng.choice(spec.device_classes) for _ in range(n)]
    # the DP grows plans over device prefixes: lead with the most
    # capable sampled class so star hubs / plan anchors are credible
    classes.sort(key=lambda c: -max(CATALOG[m].flops
                                    for m in DEVICE_CLASSES[c]))
    device_names = tuple(rng.choice(DEVICE_CLASSES[c]) for c in classes)
    throttles = tuple(
        (d, round(rng.uniform(0.5, 0.8), 4))
        for d in range(n) if rng.random() < spec.throttle_p)

    link_mbps = round(rng.uniform(*lt.mbps), 3)
    link_latency = round(rng.uniform(*lt.latency_s), 6)
    edges: Tuple[Tuple[int, int], ...] = ()
    if topology_family == "mesh":
        edges = _sample_mesh_edges(rng, n)

    mode = rng.choice(spec.modes)
    seq_len = rng.choice((64, 128, 256, 512))
    if mode == "train":
        global_batch = rng.choice((8, 16, 32))
        microbatch = rng.choice((1, 2, 4))
        optimizer_mult = rng.choice((3.0, 8.0))
    else:
        global_batch = rng.choice((1, 2, 4, 8))
        microbatch = 1
        optimizer_mult = 1.0

    # memory-feasibility filter: keep only models whose (optimizer-
    # inflated) parameters fit in ~80% of the fleet's aggregate memory;
    # every family lists a tiny fallback that always fits
    devs = [CATALOG[m] for m in device_names]
    cap = 0.8 * sum(d.memory for d in devs)
    mult = optimizer_mult + 1.0 if mode == "train" else 1.2
    fitting = [m for m in spec.models
               if _model_param_bytes(m) * mult <= cap]
    model = rng.choice(fitting) if fitting else "tiny_lm_4"

    n_micro = max(1, global_batch // microbatch)
    ideal = _ideal_latency(devs, model, mode, seq_len, n_micro,
                           link_mbps=link_mbps,
                           link_latency_s=link_latency)
    t_qoe = round(ideal * rng.uniform(*spec.qoe_slack), 6)
    lam = rng.choice((10.0, 50.0, 100.0, 200.0))
    e_qoe = None
    if rng.random() < spec.energy_budget_p:
        # envelope: average compute energy per device plus idle draw
        # over the latency target, with generous slack
        g = _model_graph(model, seq_len if mode == "train" else 1)
        flops = sum(nd.flops_fwd for nd in g.nodes)
        if mode == "train":
            flops = 3.0 * flops * n_micro
        e_est = (flops * max(d.e_flop for d in devs) / n
                 + max(d.p_idle for d in devs) * t_qoe)
        e_qoe = round(e_est * rng.uniform(2.0, 6.0), 4)
    request_rate = (round(rng.uniform(0.02, 0.4), 4) if mode == "train"
                    else round(rng.uniform(0.5, 10.0), 4))

    # -- dynamics timeline -----------------------------------------------------
    resources = _resource_names(topology_family, tech, n, edges)
    churnable = _churn_candidates(n, topology_family, edges)
    events: List[Tuple[str, float, str, float]] = []
    n_events = rng.randint(0, spec.max_events)
    t = 0.0
    for _ in range(n_events):
        t = round(t + rng.uniform(10.0, 60.0), 3)
        kinds = [k for k in spec.dynamics
                 if k not in ("churn", "crash") or churnable]
        if not kinds:
            break
        kind = rng.choice(kinds)
        if kind == "bw_dip":
            res = rng.choice(resources)
            depth = round(1.0 - rng.uniform(*lt.dip), 4)
            events.append(("bw_dip", t, res, depth))
            t = round(t + rng.uniform(20.0, 90.0), 3)
            events.append(("bw_dip", t, res, 1.0))
        elif kind == "mobility":
            # time-varying link quality: every link re-draws its scale
            for res in resources:
                events.append(("mobility", t, res,
                               round(rng.uniform(1.0 - lt.dip[1], 1.0), 4)))
        elif kind == "throttle":
            d = rng.randrange(n)
            events.append(("throttle", t, str(d),
                           round(rng.uniform(0.4, 0.8), 4)))
            t = round(t + rng.uniform(20.0, 90.0), 3)
            events.append(("throttle", t, str(d), 1.0))
        elif kind == "churn":
            d = rng.choice(churnable)
            events.append(("churn_leave", t, str(d), 0.0))
            t = round(t + rng.uniform(30.0, 120.0), 3)
            events.append(("churn_join", t, str(d), 1.0))
        elif kind == "crash":
            # unannounced crash-stop; the repair IS announced (the
            # rebooted device re-registers via ordinary join churn)
            d = rng.choice(churnable)
            events.append(("crash", t, str(d), 0.0))
            t = round(t + rng.uniform(30.0, 120.0), 3)
            events.append(("churn_join", t, str(d), 1.0))
        elif kind == "link_flap":
            res = rng.choice(resources)
            events.append(("link_down", t, res, 0.0))
            t = round(t + rng.uniform(15.0, 60.0), 3)
            events.append(("link_up", t, res, 1.0))
        elif kind == "straggler":
            d = rng.randrange(n)
            events.append(("straggler", t, str(d),
                           round(rng.uniform(0.2, 0.6), 4)))
            t = round(t + rng.uniform(20.0, 90.0), 3)
            events.append(("straggler", t, str(d), 1.0))
    events.sort(key=lambda e: e[1])

    # batteries draw LAST and only for battery families: every draw
    # before this point replays the exact pre-battery RNG stream, so
    # existing families' golden summaries stay byte-identical
    batteries: Tuple[Tuple[int, float], ...] = ()
    if spec.battery_p > 0.0:
        batteries = tuple(
            (d, round(devs[d].p_idle * rng.uniform(*spec.battery_idle_s), 1))
            for d in range(n) if rng.random() < spec.battery_p)

    return ScenarioParams(
        family=family, seed=seed, topology_family=topology_family,
        tech=tech, device_names=device_names, throttles=throttles,
        link_mbps=link_mbps, link_latency_s=link_latency, edges=edges,
        model=model, mode=mode, seq_len=seq_len, global_batch=global_batch,
        microbatch_size=microbatch, optimizer_mult=optimizer_mult,
        t_qoe=t_qoe, e_qoe=e_qoe, lam=lam, request_rate=request_rate,
        events=tuple(events), batteries=batteries)


def scenario_from_params(params: ScenarioParams, *,
                         name: Optional[str] = None,
                         description: Optional[str] = None) -> Scenario:
    """Materialize a :class:`Scenario` from a sampled parameter bundle."""
    spec = FAMILIES[params.family]
    wl = Workload(global_batch=params.global_batch,
                  microbatch_size=params.microbatch_size,
                  training=params.mode == "train",
                  optimizer_mult=params.optimizer_mult)
    return Scenario(
        name=name or params.name,
        description=description
        or (f"[generated:{params.family}] {spec.description} "
            f"(seed {params.seed}: {params.topology_family}/"
            f"{params.tech}, {len(params.device_names)} devices)"),
        topology=params.build_topology,
        model=_model_ref(params.model),
        workload=wl,
        qoe=QoESpec(t_qoe=params.t_qoe, e_qoe=params.e_qoe, lam=params.lam),
        seq_len=params.seq_len,
        tags=("generated", params.family, params.topology_family,
              params.mode),
        timeline=params.timeline(),
        request_rate=params.request_rate,
    )


def generate(family: str, seed: int = 0, **overrides) -> Scenario:
    """One deterministic scenario for ``(family, seed)``.

    ``overrides`` replace sampled fields of the underlying
    :class:`ScenarioParams` before the scenario is built (e.g.
    ``model="tiny_lm_4"``, ``t_qoe=1.0``, ``events=()``) — the name
    keeps the ``gen/<family>/<seed>`` form either way.
    """
    params = sample_params(family, seed)
    if overrides:
        bad = set(overrides) - {f.name for f in
                                dataclasses.fields(ScenarioParams)}
        if bad:
            raise TypeError(f"unknown ScenarioParams overrides: {sorted(bad)}")
        params = dataclasses.replace(params, **overrides)
    return scenario_from_params(params)


def generate_many(families: Optional[Sequence[str]] = None,
                  seeds: Sequence[int] = range(10)) -> List[Scenario]:
    """The cross product ``families × seeds`` as scenarios (generation
    order: family-major, matching :func:`list_families`)."""
    out = []
    for family in (families or list_families()):
        for seed in seeds:
            out.append(generate(family, seed))
    return out


def register_generated(family: str, seed: int, *, name: Optional[str] = None,
                       description: Optional[str] = None,
                       overwrite: bool = False, **overrides) -> Scenario:
    """Generate and push into the global scenario registry (the normal
    ``repro_torch.scenarios.register`` idiom).  ``name``/``description``
    rename the registered copy (e.g. the catalog's ``lossy_mesh``
    representative); the generated tags are preserved."""
    sc = generate(family, seed, **overrides)
    fields = {}
    if name is not None:
        fields["name"] = name
    if description is not None:
        fields["description"] = description
    if fields:
        sc = dataclasses.replace(sc, **fields)
    return register(sc, overwrite=overwrite)


def summarize(ref) -> str:
    """Canonical summary for a ``(family, seed)`` pair or
    :class:`ScenarioParams` (what the golden file locks)."""
    if isinstance(ref, ScenarioParams):
        return ref.summary()
    family, seed = ref
    return sample_params(family, seed).summary()


# -- fleet family: mixed train + serve ------------------------------------------
def generate_fleet(seed: int = 0, *, name: Optional[str] = None):
    """The ``mixed_train_serve`` fleet family: a fine-tuning tenant
    co-deployed with a serving tenant on one generated shared-capable
    fleet (smart-home or edge-site archetype).  Deterministic per seed;
    returns an *unregistered* :class:`repro_torch.fleet.FleetScenario`.
    """
    from ..fleet import FleetScenario
    rng = _rng("mixed_train_serve", seed)
    base_family = rng.choice(("smart_home", "edge_sites"))
    base_seed = rng.randrange(1 << 16)
    base = sample_params(base_family, base_seed)
    # the shared fleet: the base draw's topology, no timeline churn of
    # its own (fleet timelines are sampled below, in fleet device space)
    devs = [CATALOG[m] for m in base.device_names]
    tune_model = rng.choice(("tiny_lm_8", "bert"))
    tune_gb = rng.choice((8, 16))
    tune = dataclasses.replace(
        base, mode="train", model=tune_model,
        global_batch=tune_gb, microbatch_size=2,
        optimizer_mult=3.0, events=(),
        t_qoe=round(_ideal_latency(devs, tune_model, "train", base.seq_len,
                                   tune_gb // 2, link_mbps=base.link_mbps,
                                   link_latency_s=base.link_latency_s)
                    * rng.uniform(2.0, 6.0), 6),
        e_qoe=None,
        request_rate=round(rng.uniform(0.02, 0.1), 4))
    serve_model = rng.choice(("tiny_lm_4", "bert"))
    serve = dataclasses.replace(
        base, mode="serve", model=serve_model,
        global_batch=rng.choice((1, 2, 4)), microbatch_size=1,
        optimizer_mult=1.0, events=(),
        t_qoe=round(_ideal_latency(devs, serve_model, "serve", base.seq_len,
                                   1, link_mbps=base.link_mbps,
                                   link_latency_s=base.link_latency_s)
                    * rng.uniform(4.0, 12.0), 6),
        e_qoe=None,
        lam=rng.choice((100.0, 200.0)),
        request_rate=round(rng.uniform(0.5, 4.0), 4))
    tenants = (
        scenario_from_params(tune, name=f"gen_tune_{seed:04d}",
                             description="Generated fine-tuning tenant."),
        scenario_from_params(serve, name=f"gen_serve_{seed:04d}",
                             description="Generated serving tenant."),
    )
    timeline: List[Tuple[str, DynamicsEvent]] = []
    resources = _resource_names(base.topology_family, base.tech,
                                len(base.device_names), base.edges)
    if rng.random() < 0.8:
        res = rng.choice(resources)
        t0 = round(rng.uniform(20.0, 60.0), 3)
        depth = round(1.0 - rng.uniform(*LINK_TECHS[base.tech].dip), 4)
        timeline.append((f"bw_dip: {res} -> x{format(depth, '.3g')}",
                         DynamicsEvent(t=t0, bandwidth_scale={res: depth})))
        timeline.append((f"bw_dip: {res} recovers",
                         DynamicsEvent(t=round(t0 + rng.uniform(30.0, 90.0), 3),
                                       bandwidth_scale={res: 1.0})))
    return FleetScenario(
        name=name or f"gen/mixed_train_serve/{seed:04d}",
        description=f"[generated:mixed_train_serve] overnight tune + "
                    f"always-on serving on one generated "
                    f"{base.topology_family}/{base.tech} fleet "
                    f"(seed {seed}).",
        topology=base.build_topology,
        tenants=tenants,
        timeline=tuple(timeline),
        tags=("fleet", "generated", "mixed_train_serve"),
    )
