"""Timing primitives for the calibration microbenchmarks (PyTorch
counterpart of ``repro.calibrate.timing``).

Warm the callable up so first-call costs (kernel builds, the caching
allocator's first blocks, cuBLAS handles) never land in the timed region,
synchronise the devices of its outputs so asynchronous launches do not
lie, take best-of-N **wall** seconds so scheduler noise on a shared host
biases upward only, and cache the resulting seconds in a JSON file keyed
by (bench, shape, backend) so repeated calibration runs are cheap.

Wall time, not CUDA events: ``fidelity.execute_layout`` times a whole
pipelined iteration, whose host-side launches between kernels are part of
what the planner's prediction is compared with; timing the
microbenchmarks by device time alone would leave that share out of one
side of the comparison only.

The JAX package's ``ensure_host_devices`` has no counterpart: the port's
logical fleet (``Fleet``) is a count of pipeline stages on one device,
not XLA's forced host-platform devices, and needs no environment flag.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

@dataclasses.dataclass(frozen=True)
class Fleet:
    """The measured device and the logical fleet on it: ``n_devices``
    logical devices ``host<i>``, all on that one device (the card, where the
    pipeline executor places every stage of a one-card machine; or the
    CPU). The JAX package reads these from jax's backend and device count;
    here the caller states them. A fleet on "cuda" where no card is present raises: a
    measurement never falls back to the CPU."""

    device: str = "cuda"
    n_devices: int = 4

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"a fleet needs a device, not {self.n_devices}")
        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("calibration on 'cuda' needs a CUDA device and none is "
                               "present; pass --device cpu to measure the CPU instead")

    def torch_device(self) -> torch.device:
        """The device the single-device benchmarks run on."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def devices(self, n: Optional[int] = None) -> List[torch.device]:
        """The torch device of each of the first ``n`` (all by default)
        logical devices: the fleet's one device."""
        return [self.torch_device()] * (self.n_devices if n is None else n)


def _devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def block(tree):
    """Synchronise the CUDA devices of the tensors in ``tree``; returned."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def full_f32():
    """float32 matrix products in full float32 inside the block (TF32 off,
    as ``chip_smoke.py`` sets it), whatever the caller had set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def time_callable(fn: Callable[[], object], *, warmup: int = 2,
                  repeats: int = 5) -> float:
    """Best-of-``repeats`` wall seconds of ``fn`` (outputs synchronised).

    ``fn`` must be self-contained (arguments already closed over and
    device-resident).  The first ``warmup`` calls absorb first-call costs
    and are discarded.
    """
    for _ in range(max(warmup, 0)):
        block(fn())
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        block(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def backend_key(fleet: Optional[Fleet] = None) -> str:
    """``<device type>/<logical fleet size>/torch-<version>/cuda-<version>/<device
    name>`` of ``fleet`` (``Fleet()`` by default) -- the environment part of
    every cache key (a measurement from another device, fleet size or
    software stack must never be reused)."""
    fleet = fleet if fleet is not None else Fleet()
    dev = fleet.torch_device()
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        import platform
        name = platform.processor() or platform.machine()
    return (f"{dev.type}/{fleet.n_devices}/torch-{torch.__version__}/cuda-{torch.version.cuda}"
            f"/{name}")


DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch-calibrate", "measurements.json")


class MeasurementCache:
    """JSON-backed memo of microbenchmark measurements.

    Keys are ``"<bench>|<shape>|<backend_key>"`` -- bench name, a
    canonical shape string (the *arch/shape* part), and the environment
    from :func:`backend_key`.  Values are plain floats (seconds or
    bytes/s).  The file is rewritten atomically after every new
    measurement; corrupt/missing files degrade to an empty cache.

    Pass ``path=None`` for a purely in-memory cache (tests, CI runs that
    must re-measure on their own hardware). ``fleet`` (``Fleet()`` by
    default) is what the cached drivers measure on, and part of every key.
    """

    def __init__(self, path: Optional[str] = DEFAULT_CACHE, fleet: Optional[Fleet] = None):
        self.path = path
        self.fleet = fleet if fleet is not None else Fleet()
        self._data: Dict[str, float] = {}
        self.hits = 0
        self.misses = 0
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    loaded = json.load(f)
                if isinstance(loaded, dict):
                    self._data = {str(k): float(v) for k, v in loaded.items()
                                  if isinstance(v, (int, float))}
            except (OSError, ValueError):
                self._data = {}

    def key(self, bench: str, shape: str, env: Optional[str] = None) -> str:
        return f"{bench}|{shape}|{env if env is not None else backend_key(self.fleet)}"

    def lookup(self, bench: str, shape: str) -> Optional[float]:
        """Cached value for (bench, shape, backend), or ``None``."""
        return self._data.get(self.key(bench, shape))

    def put(self, bench: str, shape: str, value: float) -> float:
        self._data[self.key(bench, shape)] = float(value)
        self._flush()
        return float(value)

    def get_or_measure(self, bench: str, shape: str,
                       measure: Callable[[], float]) -> float:
        """Cached value for (bench, shape, backend) or run ``measure``."""
        val = self.lookup(bench, shape)
        if val is not None:
            self.hits += 1
            return val
        self.misses += 1
        return self.put(bench, shape, measure())

    def _flush(self) -> None:
        if not self.path:
            return
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass                    # cache is best-effort, never fatal

    def __len__(self) -> int:
        return len(self._data)
