"""Start a group of ranks, one process each, for ``torch.distributed``.

``run_ranks(fn, world, args, backend=..., timeout=...)`` spawns ``world``
processes (the ``spawn`` start method: CUDA does not survive ``fork``),
joins them into one process group and calls ``fn(rank, world, *args)`` in
each; it returns the ranks' results in rank order. The group meets through
a ``file://`` store in a fresh temporary directory, so concurrent callers
(parallel test workers) never race for a TCP port. The caller names the
backend (``"gloo"`` or ``"nccl"``) and each rank's device (``devices[rank]``,
``"cpu"`` when none are given); nothing here picks either from the machine.

A rank keeps its generation-0 rank as its id. ``regroup(survivors,
generation)`` lets the ranks in ``survivors`` (ids) leave their group and
form a new one of their own through a fresh store file beside the first
(``gen<generation>``): world = the number of survivors, rank = the position
of the id among them. A rank not among the survivors just leaves.
``leave()`` quits the group without a word to the peers: an nccl group is
aborted once this rank's queued work is done (a graceful destroy finalizes
the communicators with every peer, so it waits on a peer that is gone, or
on one that is still running), a gloo group destroyed (local). A rank that
leaves on a failure verdict touches nothing of the old group again.

A rank that raises makes the call raise ``ProcessRaisedException`` with the
traceback of every rank that raised (the others are stopped); a run that
outlives ``timeout`` seconds is killed and raises ``TimeoutError``. The group's own collectives
and point-to-point calls time out after ``timeout`` as well, so a ``recv``
whose ``send`` never comes ends as an error in its rank.

Everything passed to the ranks and returned by them is pickled: ``fn`` must
be importable by its module path, and results travel as one ``torch.save``
file per rank (tensors come back on the CPU).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


_GROUP: dict = {}      # this rank's id, device, backend, store directory and timeout


def rank_device() -> Optional[torch.device]:
    """The device ``run_ranks`` gave this rank; None in a process it did not
    start."""
    return _GROUP.get("device")


def _join(generation: int, rank: int, world: int) -> None:
    g = _GROUP
    dist.init_process_group(g["backend"], init_method=f"file://{g['store']}/gen{generation}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=g["timeout"]))


def leave() -> None:
    """Leave the current group, if any (see the module docstring)."""
    if not dist.is_initialized():
        return
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if "nccl" in str(dist.get_backend()) and abort is not None:
        torch.cuda.synchronize()
        abort()
    else:
        dist.destroy_process_group()


def regroup(survivors: Sequence[int], generation: int) -> bool:
    """Leave the current group (if this rank has not left yet); on a rank
    whose id is in ``survivors``, join the survivors' group of
    ``generation`` (see the module docstring). Returns whether this rank is
    in the new group."""
    if not _GROUP:
        raise RuntimeError("regroup: this process was not started by run_ranks")
    leave()
    order = sorted(survivors)
    if _GROUP["id"] not in order:
        return False
    _join(generation, order.index(_GROUP["id"]), len(order))
    return True


def _rank_main(rank: int, fn: Callable[..., Any], world: int, args: tuple, backend: str,
               devices: Optional[Sequence[str]], store: str, out_dir: str,
               timeout: float) -> None:
    torch.set_num_threads(1)
    device = torch.device(devices[rank] if devices is not None else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _GROUP.update(id=rank, device=device, backend=backend, store=store, timeout=timeout)
    _join(0, rank, world)
    try:
        result = fn(rank, world, *args)
        torch.save(_to_cpu(result), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        leave()


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _tracebacks(ctx) -> List[str]:
    out = []
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path):
            with open(path, "rb") as fh:          # written by this call's own ranks
                out.append(f"\n-- rank {r} raised:\n{pickle.load(fh)}")
    return out


def run_ranks(fn: Callable[..., Any], world: int, args: tuple = (), *, backend: str,
              timeout: float, devices: Optional[Sequence[str]] = None) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks of one process
    group; returns the ranks' results, rank 0 first (see the module
    docstring for failures and timeouts)."""
    if devices is not None and len(devices) != world:
        raise ValueError(f"{world} ranks but {len(devices)} devices were given")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks-")
    os.makedirs(os.path.join(tmp, "store"))
    ctx = mp.start_processes(_rank_main, nprocs=world, join=False, start_method="spawn",
                             args=(fn, world, args, backend,
                                   None if devices is None else [str(d) for d in devices],
                                   os.path.join(tmp, "store"), tmp, timeout))
    deadline = time.monotonic() + timeout
    try:
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic()), grace_period=2.0):
                if time.monotonic() >= deadline:
                    alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                    raise TimeoutError(f"ranks {alive} of {world} still running after {timeout} s")
        except mp.ProcessRaisedException as e:
            # the first rank to exit may only report a peer's failure: name every one
            raise mp.ProcessRaisedException("".join(_tracebacks(ctx)), e.error_index,
                                            e.error_pid) from None
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for path in ctx.error_files:
            if os.path.exists(path):
                os.unlink(path)
        shutil.rmtree(tmp, ignore_errors=True)
