# A copy of src/repro/core/device.py (the port imports nothing of the JAX package).
# Keep it verbatim: the port's plans must match the reference's to the last bit.
"""Device, link and topology models for Dora's planner.

The paper plans over heterogeneous edge devices (phones, laptops, edge
servers) joined by contention-prone networks (shared WiFi, wired rings).
``DeviceProfile`` captures compute/memory/energy envelopes; ``Topology``
captures the communication substrate at two fidelities:

* ``peak_bandwidth(i, j)`` — the *contention-free* point-to-point
  bandwidth used by Phase 1's relaxed model (§4.1);
* ``resources_between(i, j)`` — the set of shared resources a transfer
  occupies, used by Phase 2's contention-aware scheduler (§4.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

MBPS = 1e6 / 8.0  # bytes/sec per Mbps
GBPS = 1e9 / 8.0


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A single edge device (or TPU slice when planning for pods)."""

    name: str
    flops: float                  # peak FLOP/s (fp16/bf16)
    memory: float                 # bytes of accelerator-visible memory
    mem_bw: float = 50e9          # bytes/sec HBM/LPDDR bandwidth
    e_flop: float = 5e-12         # joules per FLOP at full tilt
    e_byte: float = 30e-9         # joules per network byte (radio/NIC)
    p_idle: float = 2.0           # watts while participating but idle
    n_accel: int = 1              # accelerators per node (TP stays in-node, §4.1)
    tp_efficiency: float = 0.85   # scaling efficiency of in-node TP
    compute_efficiency: float = 0.45  # achievable fraction of peak (MFU-ish)
    #: finite battery budget in joules (None = wall-powered); drained by
    #: the serving kernel's energy attribution when battery tracking is
    #: armed (:class:`repro_torch.control.plane.ControlConfig`)
    battery_j: Optional[float] = None

    def effective_flops(self, tp_degree: int = 1) -> float:
        tp = min(max(tp_degree, 1), self.n_accel)
        eff = self.compute_efficiency * (self.tp_efficiency ** max(tp - 1, 0))
        return self.flops * tp * eff

    def compute_time(self, flops: float, tp_degree: int = 1) -> float:
        if flops <= 0.0:
            return 0.0
        return flops / self.effective_flops(tp_degree)

    def compute_energy(self, flops: float) -> float:
        return flops * self.e_flop


@dataclasses.dataclass(frozen=True)
class LinkResource:
    """A schedulable network resource with a capacity (bytes/sec).

    A shared WiFi medium is one resource that *every* flow between its
    members occupies; a wired p2p link is a resource only its endpoints
    use. The bandwidth-feasibility constraint of Eq. (6) is enforced per
    resource.
    """

    name: str
    capacity: float               # bytes/sec
    members: FrozenSet[int]       # device indices attached
    shared: bool = True           # shared medium vs dedicated pair link
    latency: float = 0.0          # per-message latency (sec): WiFi MAC/RTT


class Topology:
    """Network topology over an ordered set of devices."""

    def __init__(self, devices: Sequence[DeviceProfile],
                 resources: Sequence[LinkResource],
                 p2p: Optional[Dict[Tuple[int, int], List[str]]] = None):
        self.devices = list(devices)
        self.resources = {r.name: r for r in resources}
        # explicit routing table: (i, j) -> list of resource names the
        # transfer traverses. When absent we fall back to any shared
        # medium containing both endpoints.
        self._p2p = dict(p2p or {})
        # route/bandwidth memos — a Topology is immutable after
        # construction (calibration and churn build new instances), and
        # the planner asks for the same pairs millions of times
        self._route_cache: Dict[Tuple[int, int], List[LinkResource]] = {}
        self._bw_cache: Dict[Tuple[int, int], float] = {}
        self._lat_cache: Dict[Tuple[int, int], float] = {}

    # -- construction helpers -------------------------------------------------
    @classmethod
    def shared_medium(cls, devices: Sequence[DeviceProfile], capacity_mbps: float,
                      name: str = "wifi", latency: float = 3e-3) -> "Topology":
        """All devices hang off one shared medium (home WiFi)."""
        res = LinkResource(name=name, capacity=capacity_mbps * MBPS,
                           members=frozenset(range(len(devices))), shared=True,
                           latency=latency)
        return cls(devices, [res])

    @classmethod
    def ring(cls, devices: Sequence[DeviceProfile], link_mbps: float,
             name: str = "ring", latency: float = 0.5e-3) -> "Topology":
        """Wired ring: dedicated links between neighbours; multi-hop
        transfers traverse every intermediate link."""
        n = len(devices)
        resources = []
        for i in range(n):
            j = (i + 1) % n
            resources.append(LinkResource(
                name=f"{name}-{i}-{j}", capacity=link_mbps * MBPS,
                members=frozenset((i, j)), shared=False, latency=latency))
        p2p: Dict[Tuple[int, int], List[str]] = {}
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                # take the shorter arc around the ring
                fwd = [(k % n, (k + 1) % n) for k in range(i, i + (j - i) % n)]
                bwd_len = n - (j - i) % n
                bwd = [((k - 1) % n, k % n) for k in range(i, i - bwd_len, -1)]
                hops = fwd if len(fwd) <= len(bwd) else bwd
                p2p[(i, j)] = [f"{name}-{min(a, b)}-{max(a, b)}"
                               if False else _ring_link_name(name, a, b, n)
                               for a, b in hops]
        return cls(devices, resources, p2p)

    @classmethod
    def mixed(cls, devices: Sequence[DeviceProfile],
              resources: Sequence[LinkResource],
              p2p: Optional[Dict[Tuple[int, int], List[str]]] = None) -> "Topology":
        return cls(devices, resources, p2p)

    @classmethod
    def from_edges(cls, devices: Sequence[DeviceProfile],
                   edges: Sequence[Tuple[int, int]], link_mbps: float,
                   name: str = "link", latency: float = 0.5e-3) -> "Topology":
        """Dedicated p2p links along an explicit edge list; every other
        pair routes over a fewest-hops path (multi-hop transfers occupy
        every intermediate link).  The generic constructor behind
        :meth:`star`, :meth:`line` and :meth:`mesh`.  Raises
        ``ValueError`` when the edge list leaves the fleet disconnected
        or references unknown devices.
        """
        n = len(devices)
        resources: List[LinkResource] = []
        adj: Dict[int, Dict[int, str]] = {}
        seen: set = set()
        for a, b in edges:
            if not (0 <= a < n and 0 <= b < n) or a == b:
                raise ValueError(f"bad edge ({a}, {b}) for a {n}-device fleet")
            lo, hi = min(a, b), max(a, b)
            if (lo, hi) in seen:
                continue
            seen.add((lo, hi))
            lname = f"{name}-{lo}-{hi}"
            resources.append(LinkResource(
                name=lname, capacity=link_mbps * MBPS,
                members=frozenset((lo, hi)), shared=False, latency=latency))
            adj.setdefault(lo, {})[hi] = lname
            adj.setdefault(hi, {})[lo] = lname
        p2p: Dict[Tuple[int, int], List[str]] = {}
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                route = _shortest_route(adj, i, j)
                if route is None:
                    raise ValueError(
                        f"edge list leaves devices {i} and {j} disconnected")
                p2p[(i, j)] = route
        return cls(devices, resources, p2p)

    @classmethod
    def star(cls, devices: Sequence[DeviceProfile], link_mbps: float,
             name: str = "star", latency: float = 0.5e-3,
             hub: int = 0) -> "Topology":
        """Hub-and-spoke: dedicated hub↔leaf links; leaf↔leaf transfers
        traverse both legs through the hub.  The hub defaults to device
        0 (the partitioner's DP grows plans over device prefixes, so the
        best-connected device should lead)."""
        edges = [(hub, i) for i in range(len(devices)) if i != hub]
        return cls.from_edges(devices, edges, link_mbps, name=name,
                              latency=latency)

    @classmethod
    def line(cls, devices: Sequence[DeviceProfile], link_mbps: float,
             name: str = "hop", latency: float = 0.5e-3) -> "Topology":
        """Multi-hop chain 0–1–…–(n-1): each transfer traverses every
        intermediate link (vehicle convoys, daisy-chained gateways)."""
        edges = [(i, i + 1) for i in range(len(devices) - 1)]
        return cls.from_edges(devices, edges, link_mbps, name=name,
                              latency=latency)

    @classmethod
    def mesh(cls, devices: Sequence[DeviceProfile], link_mbps: float,
             name: str = "mesh", latency: float = 0.5e-3,
             edges: Optional[Sequence[Tuple[int, int]]] = None) -> "Topology":
        """Dedicated pairwise links — a full mesh by default, or a
        partial mesh over an explicit ``edges`` list (missing pairs
        route multi-hop; a disconnected edge list raises
        ``ValueError``)."""
        if edges is None:
            n = len(devices)
            edges = [(i, j) for i in range(n) for j in range(i + 1, n)]
        return cls.from_edges(devices, edges, link_mbps, name=name,
                              latency=latency)

    # -- queries ---------------------------------------------------------------
    def resources_between(self, i: int, j: int) -> List[LinkResource]:
        if i == j:
            return []
        key = (i, j)
        route = self._route_cache.get(key)
        if route is not None:
            return route
        if key in self._p2p:
            route = [self.resources[n] for n in self._p2p[key]]
        else:
            out = []
            for r in self.resources.values():
                if r.shared and i in r.members and j in r.members:
                    out.append(r)
            if not out:
                raise KeyError(f"no route between device {i} and {j}")
            route = [min(out, key=lambda r: -r.capacity)]  # best shared medium
        self._route_cache[key] = route
        return route

    def peak_bandwidth(self, i: int, j: int) -> float:
        """Contention-free peak p2p bandwidth (Phase-1 relaxation)."""
        if i == j:
            return math.inf
        bw = self._bw_cache.get((i, j))
        if bw is None:
            bw = min(r.capacity for r in self.resources_between(i, j))
            self._bw_cache[(i, j)] = bw
        return bw

    def route_latency(self, i: int, j: int) -> float:
        if i == j:
            return 0.0
        lat = self._lat_cache.get((i, j))
        if lat is None:
            lat = sum(r.latency for r in self.resources_between(i, j))
            self._lat_cache[(i, j)] = lat
        return lat

    def transfer_time(self, i: int, j: int, nbytes: float) -> float:
        if i == j or nbytes <= 0.0:
            return 0.0
        return self.route_latency(i, j) + nbytes / self.peak_bandwidth(i, j)

    @property
    def n(self) -> int:
        return len(self.devices)

    def scale_resources(self, factors: Dict[str, float]) -> "Topology":
        """A new topology with link capacities scaled per resource name.

        ``factors`` maps resource names to capacity multipliers (0.5 =
        half the bandwidth); unnamed resources keep their capacity.
        Routing (explicit p2p routes and shared-medium fallbacks) is
        preserved.  The multi-tenant fleet planner uses this to price a
        shared medium at its fluid-fair share when several tenants'
        pipelines transfer over it concurrently.
        """
        bad = [n for n in factors if n not in self.resources]
        if bad:
            raise KeyError(f"unknown resources {sorted(bad)}; topology has "
                           f"{sorted(self.resources)}")
        resources = [dataclasses.replace(r, capacity=r.capacity
                                         * factors.get(r.name, 1.0))
                     for r in self.resources.values()]
        return Topology(self.devices, resources, self._p2p)

    # -- churn (runtime join/leave) --------------------------------------------
    def subset(self, keep: Sequence[int]
               ) -> Tuple["Topology", Dict[int, int]]:
        """The surviving fleet after devices leave (or rejoin).

        ``keep`` — indices *of this topology* that remain. Returns the
        shrunk topology (devices re-indexed ``0..len(keep)-1`` in sorted
        order) plus the old→new index mapping. Link resources keep their
        names (so accumulated ``bandwidth_scale`` entries stay valid)
        but drop departed members; resources left with fewer than two
        members disappear. Explicit routes that traversed a dropped
        resource are re-derived over the surviving links (ring fleets:
        traffic hops the other way around the departed node); a pair
        covered by a surviving shared medium needs no explicit route.
        Raises ``ValueError`` if the surviving fleet is disconnected.
        """
        uniq = sorted(set(keep))
        if not uniq:
            raise ValueError("subset needs at least one device")
        bad = [k for k in uniq if not (0 <= k < self.n)]
        if bad:
            raise ValueError(f"unknown device indices {bad} (fleet has "
                             f"{self.n} devices)")
        mapping = {old: new for new, old in enumerate(uniq)}
        devices = [self.devices[i] for i in uniq]
        resources: List[LinkResource] = []
        for r in self.resources.values():
            members = frozenset(mapping[m] for m in r.members if m in mapping)
            if len(members) >= 2:
                resources.append(dataclasses.replace(r, members=members))
        alive = {r.name for r in resources}
        p2p: Dict[Tuple[int, int], List[str]] = {}
        for (i, j), names in self._p2p.items():
            if i in mapping and j in mapping and all(n in alive for n in names):
                p2p[(mapping[i], mapping[j])] = list(names)
        # re-route pairs whose explicit route died with a departed device
        adj: Dict[int, Dict[int, str]] = {}
        for r in resources:
            for a in r.members:
                for b in r.members:
                    if a != b:
                        adj.setdefault(a, {}).setdefault(b, r.name)
        for i in range(len(devices)):
            for j in range(len(devices)):
                if i == j or (i, j) in p2p:
                    continue
                if any(r.shared and i in r.members and j in r.members
                       for r in resources):
                    continue        # resources_between falls back to it
                route = _shortest_route(adj, i, j)
                if route is None:
                    raise ValueError(
                        f"subset disconnects devices {uniq[i]} and "
                        f"{uniq[j]}: no surviving link or shared medium "
                        f"joins them")
                p2p[(i, j)] = route
        return Topology(devices, resources, p2p), mapping


def _shortest_route(adj: Dict[int, Dict[int, str]], src: int, dst: int
                    ) -> Optional[List[str]]:
    """BFS over link adjacency: the resource names a transfer traverses
    on a fewest-hops path src→dst, or ``None`` if disconnected."""
    prev: Dict[int, Tuple[int, str]] = {}
    frontier = [src]
    seen = {src}
    while frontier and dst not in seen:
        nxt: List[int] = []
        for a in frontier:
            for b, link in adj.get(a, {}).items():
                if b not in seen:
                    seen.add(b)
                    prev[b] = (a, link)
                    nxt.append(b)
        frontier = nxt
    if dst not in prev and dst != src:
        return None
    route: List[str] = []
    cur = dst
    while cur != src:
        cur, link = prev[cur]
        route.append(link)
    return list(reversed(route))


def _ring_link_name(name: str, a: int, b: int, n: int) -> str:
    """Canonical name of the ring link between neighbours a and b."""
    lo, hi = (a, b) if (a + 1) % n == b else (b, a)
    return f"{name}-{lo}-{(lo + 1) % n}"


# ----------------------------------------------------------------------------
# Catalogue: devices from Table 2 and TPU v5e slices for pod planning.
# FLOP/s values are public fp16/bf16 peaks; energy coefficients are derived
# from TDP / peak and calibrated against Figure 3a's order-of-magnitude
# energy-vs-speed spread.
# ----------------------------------------------------------------------------
CATALOG: Dict[str, DeviceProfile] = {
    "s25": DeviceProfile("s25", flops=2.8e12, memory=12e9, mem_bw=77e9,
                         e_flop=2.4e-12, e_byte=40e-9, p_idle=1.2),
    "mi15": DeviceProfile("mi15", flops=2.8e12, memory=12e9, mem_bw=77e9,
                          e_flop=2.4e-12, e_byte=40e-9, p_idle=1.2),
    "genio520": DeviceProfile("genio520", flops=1.6e12, memory=16e9, mem_bw=51e9,
                              e_flop=3.0e-12, e_byte=35e-9, p_idle=2.0),
    "genio720": DeviceProfile("genio720", flops=2.4e12, memory=16e9, mem_bw=68e9,
                              e_flop=2.6e-12, e_byte=35e-9, p_idle=2.2),
    "rtx4050": DeviceProfile("rtx4050", flops=15.0e12, memory=6e9, mem_bw=216e9,
                             e_flop=6.0e-12, e_byte=25e-9, p_idle=14.0),
    "rtx4060": DeviceProfile("rtx4060", flops=20.0e12, memory=8e9, mem_bw=272e9,
                             e_flop=5.8e-12, e_byte=25e-9, p_idle=16.0),
    "rtx4060ti": DeviceProfile("rtx4060ti", flops=22.0e12, memory=8e9, mem_bw=288e9,
                               e_flop=5.9e-12, e_byte=25e-9, p_idle=17.0),
    "v100": DeviceProfile("v100", flops=112.0e12, memory=16e9, mem_bw=900e9,
                          e_flop=2.2e-12, e_byte=15e-9, p_idle=55.0),
    "a40": DeviceProfile("a40", flops=149.0e12, memory=16e9, mem_bw=696e9,
                         e_flop=2.0e-12, e_byte=15e-9, p_idle=60.0),
    # TPU v5e chip as a "device" for pod-level planning (hardware target).
    "v5e": DeviceProfile("v5e", flops=197e12, memory=16e9, mem_bw=819e9,
                         e_flop=1.0e-12, e_byte=5e-9, p_idle=60.0,
                         compute_efficiency=0.55),
}


def make_setting(name: str) -> Topology:
    """The four representative edge settings of Table 3."""
    c = CATALOG
    if name == "smart_home_1":
        devs = [c["rtx4060ti"], c["rtx4060ti"], c["rtx4050"], c["rtx4050"], c["rtx4050"]]
        return Topology.shared_medium(devs, 900.0)
    if name == "smart_home_2":
        devs = [c["rtx4050"], c["rtx4050"], c["mi15"], c["mi15"], c["s25"]]
        return Topology.shared_medium(devs, 600.0)
    if name == "traffic_monitor":
        devs = [c["genio720"], c["genio720"], c["genio520"], c["genio520"]]
        wifi = LinkResource("wifi", 600.0 * MBPS, frozenset(range(4)), shared=True,
                            latency=3e-3)
        ring = Topology.ring(devs, 200.0)
        resources = list(ring.resources.values()) + [wifi]
        # route over the wired ring for neighbours, wifi otherwise
        return Topology.mixed(devs, resources, ring._p2p)
    if name == "edge_cluster":
        devs = [c["a40"], c["a40"], c["v100"], c["v100"]]
        return Topology.ring(devs, 4000.0, name="lan", latency=0.2e-3)
    raise KeyError(f"unknown setting {name}")
