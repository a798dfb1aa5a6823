"""The dry-run (``repro_torch.launch.dryrun``), the step structs and the
kernels' shape-only path, on this CPU with fake ``"cpu"`` tensors (a CPU
build of torch cannot run a fake CUDA op).

* Importing the launch modules starts no process group and touches no
  device (the reference's check, ``tests/test_system.py``).
* The cells are the reference's: ``all_cells()`` on both production meshes.
* Shallow cells (2 stacked units) of six families lower on the fake (16, 16)
  mesh, among them qwen3_32b x prefill_32k, which raised on the parent
  (KV = 8 heads viewed out of a product DTensor sharded over 16 ranks); one
  cell on the (2, 16, 16) mesh. No kernel launches, and the group is gone
  after each cell.
* The FLOP identity that the card's check rests on: on a fake one-rank
  mesh, ``per_device_flops - kernel_flops`` equals ``FlopCounterMode``'s count
  of the real CPU step minus the plain kernels' own products (counted by
  running each plain version inside a wrapper that reads the counter before
  and after its forward and its backward).
* Each kernel's shape-only outputs have the plain version's shapes and
  dtypes, a shape-only call moves no launch counter, and each op's FLOPs
  are ``kernels/flops.py``'s (the backward formulas stated in
  ``kernels/shape_only.py``).

The 66 full-depth cells are one ``slow`` test.
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import all_cells as j_all_cells
from repro_torch import kernels
from repro_torch.configs import SHAPES, ShapeSpec, reduced_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flops, ops, shape_only
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ssm
from repro_torch.optim import adamw_init

torch.set_num_threads(2)

KEYS = {"arch", "shape", "mesh", "mode", "devices", "lower_s", "memory", "per_device_flops",
        "per_device_bytes", "collectives", "roofline", "extrapolated", "kernel_flops"}
MEMORY = {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_gb"}


def test_import_starts_no_group_and_touches_no_device():
    code = ("import torch, torch.distributed as dist; "
            "from repro_torch.launch import dryrun, mesh, steps; "
            "assert not dist.is_initialized(); "
            "assert not torch.cuda.is_initialized()")
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert res.returncode == 0, res.stderr


def test_cells_are_the_reference_cells_on_both_meshes():
    want = [(a, s.name, mp) for a, s in j_all_cells() for mp in (False, True)]
    got = [(a, s.name, mp) for a, s, mp in dryrun.cells()]
    assert sorted(got) == sorted(want) and len(got) == 66


# (arch, shape, the kernels whose shape-only ops the cell runs)
SHALLOW = [
    ("qwen3_32b", "prefill_32k", {"flash_attention"}),         # raised on the parent
    ("mamba2_780m", "train_4k", {"ssd_scan", "ssd_scan_bwd"}),
    ("recurrentgemma_9b", "train_4k", {"flash_attention", "flash_attention_bwd",
                                       "rglru_scan", "rglru_scan_bwd"}),
    ("olmoe_1b_7b", "train_4k", {"flash_attention", "flash_attention_bwd"}),
    ("deepseek_v2_236b", "decode_32k", set()),                 # MLA: no kernel
    ("whisper_small", "train_4k", {"flash_attention", "flash_attention_bwd"}),
]


def _check_record(rec, arch, shape, mesh, devices, kernel_names):
    assert KEYS <= set(rec) and MEMORY == set(rec["memory"])
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"]) == \
        (arch, shape, mesh, devices)
    assert rec["mode"] == SHAPES[shape].mode and rec["extrapolated"] is False
    m = rec["memory"]
    assert m["peak_gb"] > 0 and m["argument_gb"] > 0 and m["alias_gb"] > 0
    assert m["peak_gb"] == pytest.approx(m["argument_gb"] + m["output_gb"] + m["temp_gb"]
                                         - m["alias_gb"])
    assert m["peak_gb"] >= m["argument_gb"] - 1e-9
    assert rec["per_device_flops"] > 0 and rec["per_device_bytes"] > 0
    assert set(rec["kernel_flops"]) == kernel_names
    assert sum(rec["kernel_flops"].values()) < rec["per_device_flops"]
    assert rec["collectives"] and all(v >= 0 for v in rec["collectives"].values())
    r = rec["roofline"]
    assert r["bound"] in ("compute", "memory", "collective")
    assert r["t_compute"] == pytest.approx(rec["per_device_flops"] / dryrun.PEAK_FLOPS)
    assert r["t_memory"] == pytest.approx(rec["per_device_bytes"] / dryrun.HBM_BW)


@pytest.mark.parametrize("arch,shape,kernel_names", SHALLOW,
                         ids=[f"{a}-{s}" for a, s, _ in SHALLOW])
def test_shallow_cell_on_the_16x16_mesh(arch, shape, kernel_names):
    kernels.reset_launches()
    rec = dryrun.run_cell(arch, SHAPES[shape], False, units=2, device="cpu")
    assert not dist.is_initialized()
    assert all(n == 0 for n in kernels.launch_counts().values())
    _check_record(rec, arch, shape, "16x16", 256, kernel_names)


def test_shallow_cell_on_the_2x16x16_mesh():
    rec = dryrun.run_cell("qwen3_32b", SHAPES["decode_32k"], True, units=2, device="cpu")
    assert not dist.is_initialized()
    _check_record(rec, "qwen3_32b", "decode_32k", "2x16x16", 512, {"decode_attention_partial"})
    # the same cell on one pod: the batch over twice as many ranks
    one = dryrun.run_cell("qwen3_32b", SHAPES["decode_32k"], False, units=2, device="cpu")
    assert rec["memory"]["argument_gb"] < one["memory"]["argument_gb"]


def test_group_is_destroyed_when_a_cell_fails():
    with pytest.raises(ValueError, match="remat"):
        dryrun.run_cell("qwen3_32b", SHAPES["train_4k"], False, remat="bogus", units=1,
                        device="cpu")
    assert not dist.is_initialized()


def test_main_prints_ok_and_writes_a_record_roofline_reads(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    dryrun.main(["--arch", "qwen3_32b", "--shape", "decode_32k", "--mesh", "single",
                 "--units", "1", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "[OK] qwen3_32b × decode_32k × 16x16" in text and "ALL DRY-RUN CELLS PASSED" in text
    from benchmarks import roofline
    (rec,) = roofline.load_results(str(out))
    assert KEYS <= set(rec)
    # what benchmarks/roofline.py reads of a single-pod record
    rl = rec["roofline"]
    assert rl["bound"] in ("compute", "memory", "collective") and rec["mesh"] == "16x16"
    assert roofline.model_flops(rec["arch"], rec["shape"], rec["devices"]) > 0
    assert rl["t_compute"] + rl["t_memory"] + rl["t_collective"] > 0
    assert rec["memory"]["peak_gb"] > 0


# -- the FLOP identity on one rank --------------------------------------------------
class _Own(torch.autograd.Function):
    """A plain kernel version run on its own graph, its products counted
    apart: the forward's and the backward's (``torch.autograd.grad`` of the
    same graph) FlopCounterMode deltas go to ``tally``."""

    @staticmethod
    def forward(ctx, box, *inputs):
        fn, counter, tally = box
        before = counter.get_total_flops()
        # identity hooks: the graph keeps its own saved tensors, where an
        # enclosing checkpoint's hooks would recompute the whole unit on
        # their unpack, inside the backward's count
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                                           lambda t: t):
            xs = [x.detach().requires_grad_(x.requires_grad) for x in inputs]
            outs = fn(*xs)
        tally.append(counter.get_total_flops() - before)
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        ctx.box, ctx.xs, ctx.outs, ctx.single = box, xs, outs, single
        res = tuple(o.detach() for o in outs)
        return res[0] if single else res

    @staticmethod
    def backward(ctx, *grads):
        _, counter, tally = ctx.box
        pairs = [(o, g) for o, g in zip(ctx.outs, grads) if g is not None and o.requires_grad]
        need = [x for x in ctx.xs if x.requires_grad]
        before = counter.get_total_flops()
        got = iter(torch.autograd.grad([o for o, _ in pairs], need, [g for _, g in pairs],
                                       allow_unused=True)) if pairs else iter(())
        tally.append(counter.get_total_flops() - before)
        return (None, *(next(got, None) if x.requires_grad else None for x in ctx.xs))


def _owned(monkeypatch, module, name, counter, tally):
    plain = getattr(module, name)

    def run(*args, **kw):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        rest = args[len(tensors):]

        def fn(*ts):
            return plain(*ts, *rest, **kw)
        return _Own.apply((fn, counter, tally), *tensors)
    monkeypatch.setattr(module, name, run)


# (arch, attn_chunk, remat): flash's plain version below S = 32, the SSD and
# the RG-LRU scans' (on a plain CPU tensor the mamba2 block takes the
# model's own ``ssd_chunked``, on a DTensor or the card ``ops.ssd_scan``)
IDENTITY = [("h2o_danube_1_8b", 16, "full"), ("h2o_danube_1_8b", 16, "none"),
            ("mamba2_780m", 64, "full"), ("recurrentgemma_9b", 16, "full")]


@pytest.mark.parametrize("arch,attn_chunk,remat", IDENTITY)
def test_flops_besides_the_kernels_equal_the_real_step(monkeypatch, arch, attn_chunk, remat):
    cfg = dataclasses.replace(reduced_config(arch), attn_chunk=attn_chunk)
    shape = ShapeSpec("tiny_train", 32, 2, "train")
    rec = dryrun.run_one_rank(cfg, shape, remat=remat, device="cpu")
    assert rec["kernel_flops"]

    counter, tally = FlopCounterMode(display=False), []
    for module, name in ((fa, "flash_attention_ref"), (ssm, "ssd_chunked"),
                         (ssm, "ssd_scanned"), (rg, "rglru_scan_ref")):
        _owned(monkeypatch, module, name, counter, tally)
    model, step = make_train_step(cfg, remat=remat, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g, dtype=torch.int32)
    with counter:
        step(params, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 0)
    assert tally
    assert rec["per_device_flops"] - sum(rec["kernel_flops"].values()) == \
        counter.get_total_flops() - sum(tally)


# -- the kernels' shape-only path ----------------------------------------------------
def _cases(dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=dtype):
        return torch.randn(*shape, generator=g).to(dt)
    q, k, v = r(2, 64, 4, 16), r(2, 64, 2, 16), r(2, 64, 2, 16)
    out, lse = fa.flash_attention_fwd(q, k, v)
    qd, kc, vc = r(2, 1, 4, 16), r(2, 48, 2, 16), r(2, 48, 2, 16)
    lens = torch.tensor([5, 48], dtype=torch.int32)
    x, al, b, c = r(2, 64, 4, 16), -r(2, 64, 4, dt=torch.float32).abs(), r(2, 64, 1, 16), \
        r(2, 64, 1, 16)
    a2, b2 = -r(2, 64, 8, dt=torch.float32).abs(), r(2, 64, 8, dt=torch.float32)
    h, _ = rg.rglru_scan(a2, b2)
    return [
        ("flash_attention", lambda *t: fa.flash_attention(*t), (q, k, v),
         flops.flash_attention_flops(2, 64, 4, 2, 16)),
        ("flash_attention_fwd", lambda *t: fa.flash_attention_fwd(*t), (q, k, v),
         flops.flash_attention_flops(2, 64, 4, 2, 16)),
        ("flash_attention_bwd", lambda *t: fa.flash_attention_bwd(*t), (q, k, v, out, lse, q),
         2.5 * flops.flash_attention_flops(2, 64, 4, 2, 16)),
        ("decode_attention", lambda *t: dec.decode_attention(*t), (qd, kc, vc, lens),
         flops.decode_attention_flops(2, 48, 4, 16)),
        ("decode_attention_partial",
         lambda *t: dec.decode_attention_partial(*t, kv_offset=16), (qd, kc, vc, lens),
         flops.decode_attention_flops(2, 48, 4, 16)),
        ("ssd_scan", lambda *t: ssd.ssd_scan(*t, chunk=32), (x, al, b, c),
         flops.ssd_scan_flops(2, 64, 4, 16, 1, 16)),
        ("ssd_scan_bwd", lambda *t: ssd.ssd_scan_bwd(*t, chunk=32), (x, al, b, c, x),
         2 * flops.ssd_scan_flops(2, 64, 4, 16, 1, 16)),
        ("rglru_scan", lambda *t: rg.rglru_scan(*t), (a2, b2), flops.rglru_scan_flops(2, 64, 8)),
        ("rglru_scan_bwd", lambda *t: rg.rglru_scan_bwd(*t), (a2, h, b2, b2[:, 0]),
         2 * flops.rglru_scan_flops(2, 64, 8)),
    ]


@pytest.mark.parametrize("i", range(9), ids=[c[0] for c in _cases()])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shape_only_outputs_match_the_plain_version(i, dtype):
    name, call, args, want_flops = _cases(dtype)[i]
    plain = call(*args)
    kernels.reset_launches()
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        with FlopCounterMode(display=False) as counter:
            got = call(*fake)
    flat = lambda t: [t] if isinstance(t, torch.Tensor) else list(t)     # noqa: E731
    assert [(tuple(t.shape), t.dtype) for t in flat(got)] == \
        [(tuple(t.shape), t.dtype) for t in flat(plain)]
    assert all(shape_only.data_free(t) for t in flat(got))
    assert all(n == 0 for n in kernels.launch_counts().values())
    assert counter.get_total_flops() == round(want_flops)


def test_shape_only_path_on_meta_tensors_and_with_grad():
    """Meta tensors take it too, and a shape-only forward with grad goes
    through the autograd Functions to the backward ops."""
    q, k, v = (torch.empty(2, 64, n, 16, device="meta", requires_grad=True) for n in (4, 2, 2))
    o = ops.flash_attention(q, k, v)
    assert o.is_meta and o.shape == q.shape
    with FakeTensorMode():
        x = torch.randn(2, 64, 4, 16, requires_grad=True)
        al = torch.randn(2, 64, 4, requires_grad=True)
        b, c = (torch.randn(2, 64, 1, 16, requires_grad=True) for _ in range(2))
        with FlopCounterMode(display=False) as counter:
            y, state = ops.ssd_scan(x, al, b, c, chunk=32)
            (y.sum() + state.sum()).backward()
        assert x.grad.shape == x.shape and b.grad.shape == b.shape
        counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
        assert counts["repro_torch.ssd_scan_bwd"] == 2 * counts["repro_torch.ssd_scan"]


def test_shape_only_ops_compute_the_plain_version_on_real_tensors():
    """The registered ops on real CPU tensors write the plain versions'
    values (the wrappers never send them one)."""
    name, call, args, _ = _cases(torch.float32)[0]
    q, k, v = args
    out, lse = torch.empty_like(q), torch.empty(2, 4, 64)
    shape_only.OPS["flash_attention"](q, k, v, out, lse, True, None, 16 ** -0.5)
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(lse, fa.flash_attention_lse_ref(q, k), rtol=0, atol=0)


def test_bwd_scratch_floats_mirror():
    """The Python copy of the C entry's scratch size (shape-only path): the
    float32 row sums, and the bf16 layout with and without a split group."""
    assert fa.bwd_scratch_floats(2, 100, 8, 2, 80, torch.float32, 1) == 2 * 8 * 100
    assert fa.bwd_scratch_floats(2, 100, 8, 2, 80, torch.bfloat16, 1) == 2 * 8 * 128 * 90
    assert fa.bwd_scratch_floats(2, 100, 8, 2, 80, torch.bfloat16, 2) == \
        2 * 8 * 128 * 90 + 2 * 2 * 100 * 2 * 80


# -- all 66 cells at full depth -------------------------------------------------------
@pytest.mark.slow
def test_every_cell_at_full_depth():
    failed = []
    for arch, shape, mp in dryrun.cells():
        try:
            rec = dryrun.run_cell(arch, shape, mp, device="cpu")
            assert rec["memory"]["peak_gb"] > 0 and rec["per_device_flops"] > 0
        except Exception as e:  # noqa: BLE001
            failed.append((arch, shape.name, mp, f"{type(e).__name__}: {e}"))
        assert not dist.is_initialized()
    assert not failed, failed
