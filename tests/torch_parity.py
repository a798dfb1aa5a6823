"""What the port's parity tests share: a deterministic ``time.perf_counter``
for Dora's planning stack, and comparisons of plans and nested results.

The planner, the control plane and the chaos engine read the wall clock
(``time.perf_counter``) and feed what they measure into their results:
planning seconds, a reaction's ``react_s``, and through it a stall and an
MTTR. Two runs, or the JAX package and its port, are compared exactly only
when both read one clock that ticks the same way: each read here advances
it by ``STEP``, so a measured interval counts the reads made within it.

    clock = use_clock(monkeypatch, "repro", "repro_torch")
    want = repro.dora.simulate(...)
    clock.reset()
    got = repro_torch.dora.simulate(...)

This module imports neither package, so the mirrored tests that import
only ``repro_torch`` use it on a machine without jax.
"""
import importlib
import math
import time

import pytest

STEP = 1e-4
REL = 1e-9


class Clock:
    """Stands in for the ``time`` module: ``perf_counter`` ticks, the rest
    is the real module's."""

    def __init__(self):
        self.reads = 0

    def reset(self) -> None:
        self.reads = 0

    def perf_counter(self) -> float:
        self.reads += 1
        return self.reads * STEP

    def __getattr__(self, name):
        return getattr(time, name)


# the planning stack's modules that read the clock (some are imported lazily)
READERS = ("core.planner", "core.scheduler", "core.adapter", "strategies.base",
           "control.plane", "dora", "sim.runner", "sim.serving", "fleet.planner",
           "resilience.engine")


def use_clock(monkeypatch, *packages: str) -> Clock:
    """Point the ``time`` of every module of ``packages`` at one new
    ``Clock`` (undone by ``monkeypatch``) and return it."""
    clock = Clock()
    for p in packages:
        for m in READERS:
            mod = importlib.import_module(f"{p}.{m}")
            assert mod.time is time, mod.__name__
            monkeypatch.setattr(mod, "time", clock)
    return clock


def close_tree(got, want, where="") -> None:
    """Equal nested structures; floats to ``REL`` relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            close_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            close_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (where, got, want)
        if math.isnan(want):
            assert math.isnan(got), where
        else:
            assert got == pytest.approx(want, rel=REL, abs=0.0), (where, got, want)
    else:
        assert got == want, (where, got, want)


def same_plan(got, want, ctx) -> None:
    assert [(list(s.node_ids), list(s.devices)) for s in got.stages] == \
        [(list(s.node_ids), list(s.devices)) for s in want.stages], ctx
    assert (got.microbatch_size, got.n_microbatches) == \
        (want.microbatch_size, want.n_microbatches), ctx
    for attr in ("objective", "latency", "energy"):
        assert getattr(got, attr) == pytest.approx(getattr(want, attr), rel=REL), (ctx, attr)


def both(monkeypatch, jfn, fn):
    """(port's result or error, JAX's result or error), each run from a
    fresh tick of one deterministic clock."""
    clock = use_clock(monkeypatch, "repro", "repro_torch")
    out = []
    for f in (jfn, fn):
        clock.reset()
        try:
            out.append((f(), None))
        except Exception as e:      # noqa: BLE001 -- both sides must fail alike
            out.append((None, e))
    (want, werr), (got, gerr) = out
    if werr is not None or gerr is not None:
        assert (type(gerr).__name__, str(gerr)) == (type(werr).__name__, str(werr))
        return None, None
    return got, want
