"""The measured fleet: DeviceProfiles, Topology and costs (PyTorch
counterpart of ``repro.calibrate.host``).

The fidelity loop plans over a *host fleet*: N ``host<i>`` devices, the
logical devices of a ``timing.Fleet``. The names stay the JAX package's, so
the port's ``ProfiledCosts`` for the same measurements equals the JAX
one. On a card they stand for the card itself: ``host<i>`` is logical
device i, and all of them are the one card, where the pipeline executor
runs every stage of a one-card machine; the shared medium ``hostmem`` is
that card's device memory, through which one stage's output reaches the
next. On the CPU they are what the JAX package's are: logical devices
time-sharing the host's cores and memory.

Each device's "datasheet" claims exactly what a naive single-stream
microbenchmark would claim -- sustained matmul FLOP/s, memcpy bytes/s --
priced through the library-default ``compute_efficiency`` MFU guess.
That claim is systematically wrong when N logical devices share one
device: a pipeline stage really runs at the *contended* rate, roughly
``1/N`` of single-stream, and small stage blocks run at a fraction of the
matmul peak. :func:`host_costs` converts that measured gap into a
:class:`~repro_torch.core.profiler.ProfiledCosts` via
``from_measurements``.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Mapping, Optional, Tuple

from ..core.device import DeviceProfile, LinkResource, Topology
from ..core.profiler import ProfiledCosts
from .microbench import measure_host, step_analytic_seconds
from .timing import Fleet, MeasurementCache, backend_key

#: Default accelerator-visible memory per host device.  Deliberately
#: small enough that realistic proxy models need several pipeline
#: stages; the fidelity loop overrides it per case.
HOST_MEMORY = 4e9

#: Shared-medium resource name of the fleet (the hand-offs between
#: logical devices all ride the same memory system).
HOSTMEM = "hostmem"


def host_device(measure: Mapping[str, float], index: int = 0, *,
                memory: float = HOST_MEMORY) -> DeviceProfile:
    """One ``host<i>`` DeviceProfile from measurements.

    ``flops`` is the measured single-stream matmul peak -- the number a
    datasheet (or a naive benchmark) would claim -- and
    ``compute_efficiency`` stays the library default, so *uncalibrated*
    planning over the fleet mispredicts exactly the way datasheet
    planning over a real fleet does.  ``ProfiledCosts`` then closes the
    gap from measurements.
    """
    return DeviceProfile(
        name=f"host{index}",
        flops=float(measure["matmul_peak_flops"]),
        memory=memory,
        mem_bw=float(measure["memory_bw"]),
        e_flop=1e-11, e_byte=1e-9, p_idle=5.0)


def host_topology(measure: Mapping[str, float], n: int, *,
                  memory: float = HOST_MEMORY) -> Topology:
    """``n`` host devices on one shared ``hostmem`` medium.

    The medium's claimed capacity is the measured single-stream memory
    bandwidth (the honest "datasheet" for an in-memory link); its
    per-message latency is derived from the small-vs-large transfer
    goodput gap when both were measured.
    """
    devs = [host_device(measure, i, memory=memory) for i in range(n)]
    latency = 1e-4
    small = measure.get("transfer_small_bps")
    large = measure.get("transfer_large_bps")
    if small and large and small > 0.0 and large > 0.0:
        latency = max((1 << 16) / small - (1 << 16) / large, 1e-5)
    res = LinkResource(HOSTMEM, capacity=float(measure["memory_bw"]),
                       members=frozenset(range(n)), shared=True,
                       latency=latency)
    return Topology(devs, [res])


def host_costs(measure: Mapping[str, float], n: int, *,
               contended: Optional[float] = None,
               name: str = "profiled-host",
               provenance: Optional[Mapping[str, str]] = None,
               fleet: Optional[Fleet] = None) -> ProfiledCosts:
    """Measured :class:`ProfiledCosts` for an ``n``-device fleet.

    Compute factors come from measured-vs-analytic *step seconds* of the
    contended stage block: the analytic time prices the block at the
    datasheet effective rate (matmul peak x default MFU), the measured
    time is what the block actually took per device under ``n``-way
    load (``contended`` overrides the cached default measurement, e.g.
    with a geometry-matched
    :func:`~repro_torch.calibrate.microbench.contended_mlp_rate`).  The
    ``hostmem`` bandwidth factor is measured transfer goodput over the
    claimed memory-bandwidth capacity. The provenance names ``fleet``'s
    backend (``Fleet()``'s by default).
    """
    claimed = host_device(measure).effective_flops()
    achieved = contended
    if achieved is None:
        achieved = measure.get("contended_mlp_flops") \
            or measure.get("contended_flops") \
            or float(measure["matmul_peak_flops"])
    # (analytic, measured) seconds per FLOP of the calibration block:
    # from_measurements turns the pair into achieved/claimed per device.
    device_seconds = {f"host{i}": (1.0 / claimed, 1.0 / float(achieved))
                      for i in range(n)}
    links: Dict[str, Tuple[float, float]] = {}
    transfer = measure.get("transfer_large_bps")
    if transfer:
        links[HOSTMEM] = (float(measure["memory_bw"]), float(transfer))
    pc = ProfiledCosts.from_measurements(device_seconds=device_seconds,
                                         link_bytes_per_s=links)
    prov = {
        "backend": backend_key(fleet),
        "date": datetime.date.today().isoformat(),
        "source": "repro_torch.calibrate microbenchmarks "
                  "(matmul peak, memory pass, contended stage block, "
                  "copy between logical devices)",
        "claimed_effective_flops": f"{claimed:.4g}",
        "achieved_contended_flops": f"{float(achieved):.4g}",
        **dict(provenance or {}),
    }
    return dataclasses.replace(pc, name=name, provenance=prov)


def calibrate_host(cache: Optional[MeasurementCache] = None, *,
                   quick: bool = False,
                   archs=("qwen3_32b", "mamba2_780m"),
                   path: Optional[str] = None) -> ProfiledCosts:
    """Measure the cache's fleet and build its ProfiledCosts artifact.

    Runs (or recalls from ``cache``) the microbenchmark suite --
    including the timed zoo train/decode steps, whose measured-vs-
    analytic ratios land in the provenance -- and returns the
    :class:`ProfiledCosts` for the logical fleet.  With ``path``, the
    artifact is also written as committable JSON, loadable later via
    ``repro_torch.dora.planner_for(..., costs="profiled:<path>")``.
    """
    cache = cache if cache is not None else MeasurementCache()
    measure = measure_host(cache, archs=archs, quick=quick)
    n = cache.fleet.n_devices
    prov: Dict[str, str] = {}
    dev = host_device(measure)
    for arch in archs:
        for mode in ("train", "decode"):
            measured = measure.get(f"step/{arch}/{mode}_s")
            if not measured:
                continue
            analytic = step_analytic_seconds(arch, mode, dev)
            prov[f"step_ratio/{arch}/{mode}"] = f"{analytic / measured:.4g}"
    costs = host_costs(measure, n, provenance=prov, fleet=cache.fleet)
    if path is not None:
        costs.to_json(path)
    return costs
