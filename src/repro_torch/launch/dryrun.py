"""Multi-pod dry-run (PyTorch counterpart of ``repro.launch.dryrun``): run
the train, prefill or serve step of every (arch, shape) cell on the
production meshes without a device, and record what one rank would hold,
compute and send.

    python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--mesh single|multi|both] [--remat full|dots|none] [--out FILE]

``run_cell`` starts a fake process group of 256 (``16x16``) or 512
(``2x16x16``) ranks in this process (torch's ``FakeStore`` and ``"fake"``
backend: collectives do nothing), lays the mesh out with
``make_production_mesh`` and builds the step's arguments with the step
structs (``launch/steps.py``): FakeTensor DTensors laid out by
``ShardingRules``, rank 0 holding only its own shards. It runs the port's
own step (``make_train_step``, ``make_prefill_step``, ``make_serve_step``)
under ``FakeTensorMode``, so nothing is computed and no card is needed: the
kernel wrappers take their shape-only path (``kernels/shape_only.py``). The
group is destroyed in a ``finally``. Tensors are fake ``"cuda"`` tensors
where this torch is built with CUDA, else fake ``"cpu"`` tensors (a CPU
build cannot run a fake CUDA op); kernel wrappers hold fake ``"cuda"``
tensors to the card's checks (head dims, the backward's limits).

Every figure is rank 0's, read while the step runs:

* ``per_device_flops``: ``FlopCounterMode``'s formulas applied to each op
  rank 0 runs on its local tensors (a dispatch mode that lets DTensor
  desugar first; ``FlopCounterMode`` itself would count a DTensor op at its
  global shape). The kernels count through their ops' formulas, summed by
  kernel in ``kernel_flops``.
* ``per_device_bytes``: the input and output bytes of every op rank 0
  dispatches on local tensors (views and allocations move nothing and are
  left out), the traffic of an unfused eager step, which is what the port
  runs; a kernel counts its inputs and outputs once.
* ``collectives``: each collective's result bytes times the reference's ring
  multipliers (``_RING``: (g-1)/g for an all-gather or all-to-all, g-1 for
  a reduce-scatter, 2(g-1)/g for an all-reduce), by op. The fake group's device type
  sets what DTensor issues: on a CPU mesh it moves a shard to another dim
  by an all-gather where a CUDA mesh does an all-to-all.
* ``memory`` (GB, 1e9 bytes): ``argument_gb`` the state at entry (params,
  AdamW moments and batch; or params, cache and tokens), ``alias_gb`` the
  part the step writes in place (params and moments in training, the cache
  in serving: the port updates them in place, as XLA's donation does),
  ``output_gb`` the step's outputs with the aliased ones, ``peak_gb``
  ``MemTracker``'s peak over the step, and ``temp_gb`` what is left, so that
  peak = argument + output + temp - alias as in the reference's record.
* ``roofline``: times at the H100 SXM's datasheet figures (``PEAK_FLOPS``,
  ``HBM_BW``, ``NVLINK_BW``), which bound is the largest.

These are estimates for ``HARDWARE``, not measurements. The layers run as a
Python loop, so full depth counts every layer and needs none of the
reference's 2- and 3-unit extrapolation (``extrapolated`` is always
false). ``units`` cuts a cell to that many stacked units, its tail kept
(the reference's shallow configs).

Importing this module starts no process group and touches no device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import ARCH_IDS, ShapeSpec, applicable_shapes, get_config
from ..models.config import ArchConfig
from ..models.sharding_utils import is_dtensor
from .mesh import make_mesh, make_production_mesh, use_mesh
from .steps import (batch_structs, make_prefill_step, make_serve_step, make_train_step,
                    param_structs, serve_structs, step_struct)

# NVIDIA H100 SXM datasheet figures (PERF.md §3): dense bf16 tensor-core
# peak, HBM3 bandwidth, and NVLink 4 at 900 GB/s both directions together,
# 450 GB/s a direction a GPU
HARDWARE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
ESTIMATE = f"estimate, not measured ({HARDWARE} datasheet figures)"

# ring multipliers on each collective's result bytes (the reference's
# ``collective_bytes``): g ranks in the group
_RING = {"all_gather": lambda g: (g - 1) / g, "reduce_scatter": lambda g: float(g - 1),
         "all_reduce": lambda g: 2.0 * (g - 1) / g, "all_to_all": lambda g: (g - 1) / g,
         "broadcast": lambda g: 1.0}
_COLLECTIVES = {
    "all_gather_into_tensor": "all_gather", "all_gather_into_tensor_out": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter", "all_reduce": "all_reduce",
    "all_reduce_": "all_reduce", "all_to_all_single": "all_to_all",
    "allreduce_": "all_reduce", "allgather_": "all_gather",
    "_allgather_base_": "all_gather", "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter", "alltoall_base_": "all_to_all",
    "broadcast_": "broadcast"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "_local_scalar_dense", "wait_tensor"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_size(args) -> int:
    """The size of the group a collective's arguments name (a group name or
    size of a functional collective, or a ``ProcessGroup``)."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return int(ProcessGroup.unbox(a).size())
        if isinstance(a, ProcessGroup):
            return int(a.size())
    for a in reversed(args):         # the group name comes last (after a reduce op's)
        if isinstance(a, str):
            return int(_resolve_process_group(a).size())
    raise ValueError("a collective without a group")


class StepCounter(TorchDispatchMode):
    """Counts what rank 0 runs on its local tensors (entered under the
    step's ``FakeTensorMode``): FLOPs through
    ``FlopCounterMode``'s formulas (its own decomposition rule for an op
    without one), by kernel op too; op input and output bytes; collective
    bytes by ring multiplier. A DTensor op is handed back to DTensor first
    (``NotImplemented``), so only the local ops it desugars into count."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        from ..kernels.shape_only import OPS
        self.flop_counter = FlopCounterMode(display=False)
        self.kernels = {getattr(torch.ops.repro_torch, op._name): name
                        for name, op in OPS.items()}
        self.bytes = 0
        self.collectives: Dict[str, float] = {}
        self._fake_mode = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        from torch._guards import active_fake_mode
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                active_fake_mode() is not self._fake_mode:
            # an op under another fake mode is not rank 0's work (DTensor's
            # global-shape propagation runs so, out of sight of every mode:
            # ``_propagation_apart``)
            return func(*args, **kwargs)
        fc = self.flop_counter
        packet = func._overloadpacket
        if packet not in fc.flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        fc._count_flops(packet, out, args, kwargs)
        name = packet.__name__.split(".")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            outs = tree_flatten(out)[0] if out is not None else tree_flatten(args[0])[0]
            result = sum(_nbytes(t) for t in outs if isinstance(t, torch.Tensor))
            self.collectives[kind] = self.collectives.get(kind, 0.0) + \
                result * _RING[kind](_group_size(args))
            return out
        outs = tree_flatten(out)[0]
        if name in _NO_TRAFFIC or getattr(func, "is_view", False) or (
                out is not None and not any(isinstance(t, torch.Tensor) for t in outs)):
            return out
        self.bytes += sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0]) + \
            sum(_nbytes(t) for t in outs)
        return out

    @property
    def flops(self) -> int:
        return int(self.flop_counter.get_total_flops())

    @property
    def kernel_flops(self) -> Dict[str, int]:
        counts = self.flop_counter.get_flop_counts().get("Global", {})
        return {name: int(counts[p]) for p, name in self.kernels.items() if counts.get(p)}


def roofline(per_dev_flops: float, per_dev_bytes: float,
             coll: Dict[str, float]) -> Dict[str, Any]:
    """The reference's roofline at the H100's figures: compute at
    ``PEAK_FLOPS``, memory at ``HBM_BW``, collectives at ``NVLINK_BW``."""
    coll_total = sum(coll.values())
    terms = {"compute": per_dev_flops / PEAK_FLOPS, "memory": per_dev_bytes / HBM_BW,
             "collective": coll_total / NVLINK_BW}
    return {"t_compute": terms["compute"], "t_memory": terms["memory"],
            "t_collective": terms["collective"], "bound": max(terms, key=terms.get),
            "collective_bytes": coll_total}


def _local_bytes(*trees) -> int:
    """The bytes rank 0 holds of ``trees``' tensors (a DTensor's local shard)."""
    total = 0
    for tree in trees:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                total += _nbytes(t.to_local() if is_dtensor(t) else t)
    return total


def _tensors(*trees):
    out = []
    for tree in trees:
        out += [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    return out


def default_device() -> str:
    """``"cuda"`` where this torch is built with CUDA (fake tensors stand
    for the card's), else ``"cpu"``. No card is needed either way."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def measure_step(cfg: ArchConfig, shape: ShapeSpec, mesh, *, remat: str = "full",
                 device: Optional[str] = None) -> dict:
    """Run ``shape.mode``'s step of ``cfg`` on ``mesh`` (over the current
    group) under ``FakeTensorMode`` and return its figures (the record's
    ``memory``, ``per_device_flops``, ``kernel_flops``, ``per_device_bytes``,
    ``collectives``, ``lower_s``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    device = device or default_device()
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=False), use_mesh(mesh):
        if shape.mode == "train":
            _, step = make_train_step(cfg, remat=remat, device=device)
            params, opt = param_structs(cfg, mesh, device)
            batch = batch_structs(cfg, shape, mesh, device)
            args = (params, opt, batch, step_struct(mesh, device))
            aliased = (params, opt["m"], opt["v"])
        else:
            make = make_prefill_step if shape.mode == "prefill" else make_serve_step
            _, step = make(cfg, device=device)
            params, _ = param_structs(cfg, mesh, device)
            sv = serve_structs(cfg, shape, mesh, device)
            if shape.mode == "prefill":
                args = (params, sv["tokens"], sv["cache"], sv["extras"])
            else:
                args = (params, sv["token"], sv["cache"], sv["pos"])
            aliased = (sv["cache"],)
        argument = _local_bytes(*args)
        alias = _local_bytes(*aliased)
        tracker = MemTracker()
        tracker.track_external(*_tensors(*args))
        counter = StepCounter()
        with _propagation_apart(), tracker, counter:
            out = step(*args)
        peak = sum(snap["Total"] for dev, snap in tracker.get_tracker_snapshot("peak").items()
                   if torch.device(dev).type != "meta")
        output = _local_bytes(out)
    lower_s = time.time() - t0
    temp = peak - (argument + output - alias)
    return {"lower_s": round(lower_s, 2),
            "memory": {"argument_gb": argument / 1e9, "output_gb": output / 1e9,
                       "temp_gb": temp / 1e9, "alias_gb": alias / 1e9, "peak_gb": peak / 1e9},
            "per_device_flops": float(counter.flops),
            "kernel_flops": {k: float(v) for k, v in counter.kernel_flops.items()},
            "per_device_bytes": float(counter.bytes),
            "collectives": {k: round(v, 1) for k, v in counter.collectives.items()}}


@contextlib.contextmanager
def _propagation_apart():
    """DTensor's sharding propagation runs an op without a rule on
    global-shape fake tensors (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``), under the active fake mode: inside
    the step's ``FakeTensorMode`` it would count in ``MemTracker`` and the
    ``StepCounter`` as rank 0's work. Run it with every dispatch mode off
    and under a fake mode of its own (torch 2.11's ``MemTracker`` counts
    ops under any fake mode: a 2-unit h2o train cell read 269 GB)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def apart(self, op_schema):
        with _disable_current_modes(), FakeTensorMode():
            return orig(self, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = apart
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process, this process
    rank 0 (torch's ``FakeStore``; its collectives do nothing), destroyed on
    exit. Refuses to start over an existing group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one_rank(cfg: ArchConfig, shape: ShapeSpec, *, remat: str = "full",
                 device: Optional[str] = None) -> dict:
    """``measure_step`` of any config and shape on a fake one-rank (1, 1)
    ('data', 'model') mesh: the figures a plain step on one device would
    give, each kernel at its formula (what a card's step runs besides the
    kernels is ``per_device_flops`` minus ``kernel_flops``)."""
    device = device or default_device()
    with fake_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        return measure_step(cfg, shape, mesh, remat=remat, device=device)


# -- depth: the reference's shallow configs ----------------------------------------
def shallow_cfg(cfg: ArchConfig, k: int) -> ArchConfig:
    """``cfg`` cut to ``k`` stacked units, its tail kept (the reference's
    ``_shallow_cfg``; the encoder-decoder's encoder cut to ``k`` layers too)."""
    if cfg.block_pattern:
        n = k * len(cfg.block_pattern) + cfg.n_layers % len(cfg.block_pattern)
    elif cfg.n_experts and cfg.n_dense_layers:
        n = cfg.n_dense_layers + k
    else:
        n = k
    kw = {"n_layers": n}
    if cfg.encdec:
        kw["n_enc_layers"] = k
    return dataclasses.replace(cfg, **kw)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: ShapeSpec, multi_pod: bool, remat: str = "full",
             extra: Optional[dict] = None, device: Optional[str] = None,
             units: Optional[int] = None) -> dict:
    """The dry-run record of one cell on the production mesh (module
    docstring), at full depth or cut to ``units`` stacked units."""
    cfg = get_config(arch)
    if units is not None:
        cfg = shallow_cfg(cfg, units)
    device = device or default_device()
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rec: dict = {"arch": arch, "shape": shape.name, "mesh": _mesh_name(multi_pod),
                     "mode": shape.mode, "devices": int(mesh.size()), "remat": remat,
                     "device": device, "units": units, "extrapolated": False,
                     "hardware": HARDWARE, "figures": ESTIMATE,
                     **measure_step(cfg, shape, mesh, remat=remat, device=device)}
    rec["roofline"] = roofline(rec["per_device_flops"], rec["per_device_bytes"],
                               rec["collectives"])
    if extra:
        rec.update(extra)
    return rec


def cells():
    """Every (arch, shape, multi_pod) the CLI runs with ``--mesh both``: the
    33 cells of ``configs.all_cells()`` on both production meshes."""
    return [(arch, shape, mp) for arch in ARCH_IDS for shape in applicable_shapes(arch)
            for mp in (False, True)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (estimates, no device)")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--units", type=int, default=None,
                    help="stacked units a cell keeps (default: full depth)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="fake tensors' device (default: cuda where torch is built with it)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in applicable_shapes(arch):
            if args.shape and shape.name != args.shape:
                continue
            for mp in meshes:
                tag = f"{arch} × {shape.name} × {_mesh_name(mp)}"
                try:
                    rec = run_cell(arch, shape, mp, remat=args.remat, device=args.device,
                                   units=args.units)
                    r = rec["roofline"]
                    print(f"[OK] {tag}: lower={rec['lower_s']}s "
                          f"peak={rec['memory']['peak_gb']:.2f}GB "
                          f"Tc={r['t_compute'] * 1e3:.2f}ms Tm={r['t_memory'] * 1e3:.2f}ms "
                          f"Tn={r['t_collective'] * 1e3:.2f}ms bound={r['bound']} "
                          f"({ESTIMATE})", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    rec = {"arch": arch, "shape": shape.name, "mesh": _mesh_name(mp),
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    print("ALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
