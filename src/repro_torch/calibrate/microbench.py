"""Microbenchmarks of the real compute/transfer paths on the measured device
(PyTorch counterpart of ``repro.calibrate.microbench``).

Four families, all routed through :mod:`repro_torch.calibrate.timing`:

* ``matmul_peak``   -- sustained large-matmul FLOP/s of one device in
  float32 with TF32 off (the "datasheet" number the uncalibrated host
  profile claims);
* ``kernel rates``  -- the four ported kernels (flash / decode attention,
  SSD scan, RG-LRU scan), which launch the hand-written CUDA kernels on a
  card and the plain versions on the CPU, timed against their analytic
  FLOP counts from ``repro_torch.kernels.flops``;
* ``step rates``    -- the train and decode steps of ``launch/steps.py``
  on REDUCED zoo configs, timed whole;
* ``transfers``     -- payload goodput between the first two logical
  devices, large and small, plus the *contended* per-device compute rate
  when every logical device runs the same block in turn.

The logical fleet (``timing.Fleet``) puts N devices on one card, which they
share as the pipeline executor's stages do on a one-card machine. So the
contended rate is what a stage really gets when N stages share the card,
and a transfer between two logical devices on one card is a device-memory
copy (the executor's hand-off between stages there is a no-op ``.to()``).
Each function takes the device or fleet it measures (a CUDA card by
default; where none is present it raises, never falling back to the CPU);
``measure_host`` reads it from its cache.

Everything returns plain floats so the results drop straight into the
measurement cache and the calibration artifact.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .timing import Fleet, MeasurementCache, full_f32, time_callable


def _device(device) -> torch.device:
    """``device`` ("cuda" by default), checked as ``Fleet`` checks it."""
    return Fleet(str(device) if device is not None else "cuda").torch_device()


def _fleet(fleet: Optional[Fleet]) -> Fleet:
    return fleet if fleet is not None else Fleet()


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


# -- single-device compute ------------------------------------------------------
def matmul_peak_flops(dim: int = 1024, *, repeats: int = 5, device=None) -> float:
    """Achieved FLOP/s of an f32 ``dim x dim`` matmul chain (TF32 off)."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, w = _randn(gen, (dim, dim), dev), _randn(gen, (dim, dim), dev)
    chain = 4                                   # amortize dispatch

    def run():
        y = x
        for _ in range(chain):
            y = y @ w
        return y

    with full_f32():
        sec = time_callable(run, repeats=repeats)
    return chain * 2.0 * dim ** 3 / sec


def memory_bandwidth(nbytes: int = 1 << 26, *, repeats: int = 5, device=None) -> float:
    """Achieved bytes/s of a device-memory pass (read + write)."""
    x = torch.zeros((nbytes // 4,), dtype=torch.float32, device=_device(device))
    sec = time_callable(lambda: x + 1.0, repeats=repeats)
    return 2.0 * nbytes / sec


# -- kernel rates ---------------------------------------------------------------
#: kernel_rates' shapes, the reference's: flash (B, S, H, KV, d), causal; decode
#: of one token against a full cache of DECODE_T slots at flash's (B, H, KV, d);
#: the SSD scan (B, S, H, P, G, N) and its chunk; the RG-LRU's (B, S, W)
FLASH_SHAPE = (1, 256, 4, 4, 64)
DECODE_T = 4096
SSD_SHAPE, SSD_CHUNK = (1, 256, 4, 64, 1, 64), 128
RGLRU_SHAPE = (1, 256, 512)


def kernel_rates(*, repeats: int = 3, device=None) -> Dict[str, float]:
    """Achieved FLOP/s of each ported kernel's entry point on the measured
    device (a card launches the CUDA kernels, the CPU runs the plain
    versions). Shapes are the reference's: the mid-size cases of
    ``tests/test_kernels.py``."""
    from ..kernels import flops as kf
    from ..kernels import ops

    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out: Dict[str, float] = {}
    with torch.no_grad():
        B, S, H, KV, d = FLASH_SHAPE
        q, k, v = (_randn(gen, (B, S, n, d), dev) for n in (H, KV, KV))
        sec = time_callable(lambda: ops.flash_attention(q, k, v, causal=True),
                            repeats=repeats)
        out["flash_attention"] = kf.flash_attention_flops(B, S, H, KV, d) / sec

        T = DECODE_T
        qd = _randn(gen, (B, 1, H, d), dev)
        kc, vc = _randn(gen, (B, T, KV, d), dev), _randn(gen, (B, T, KV, d), dev)
        clen = torch.full((B,), T, dtype=torch.int32, device=dev)
        sec = time_callable(lambda: ops.decode_attention(qd, kc, vc, clen), repeats=repeats)
        out["decode_attention"] = kf.decode_attention_flops(B, T, H, d) / sec

        Bs, Ss, Hs, P, G, N = SSD_SHAPE
        xs = _randn(gen, (Bs, Ss, Hs, P), dev) * 0.1
        a = -_randn(gen, (Bs, Ss, Hs), dev).abs() * 0.1
        b = _randn(gen, (Bs, Ss, G, N), dev) * 0.1
        c = _randn(gen, (Bs, Ss, G, N), dev) * 0.1
        sec = time_callable(lambda: ops.ssd_scan(xs, a, b, c, chunk=SSD_CHUNK), repeats=repeats)
        out["ssd_scan"] = kf.ssd_scan_flops(Bs, Ss, Hs, P, G, N) / sec

        Br, Sr, W = RGLRU_SHAPE
        al = -_randn(gen, (Br, Sr, W), dev).abs() * 0.3
        bb = _randn(gen, (Br, Sr, W), dev) * 0.1
        sec = time_callable(lambda: ops.rglru_scan(al, bb), repeats=repeats)
        out["rglru_scan"] = kf.rglru_scan_flops(Br, Sr, W) / sec
    return out


# -- whole-step rates -----------------------------------------------------------
def step_seconds(arch: str, mode: str = "train", *, batch: int = 2,
                 seq: int = 32, repeats: int = 3, device=None) -> float:
    """Wall seconds of one REDUCED-config step on the measured device.

    ``mode`` is ``"train"`` (full forward, backward and AdamW, remat
    "none") or ``"decode"`` (one cached serving token). This times the
    *production step functions* from ``launch/steps.py`` with real inputs;
    a training batch carries the model's frontend stub (whisper's frames,
    paligemma's patches), drawn as N(0, 0.02^2) as in the JAX package.
    """
    from ..configs import reduced_config
    from ..launch.steps import frontend_stubs, make_serve_step, make_train_step
    from ..optim import adamw_init

    cfg = reduced_config(arch)
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mode == "train":
        model, train_step = make_train_step(cfg, remat="none", device=dev)
        params = model.init(gen)
        opt = adamw_init(params)
        toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **frontend_stubs(cfg, batch, dev, gen)}
        return time_callable(lambda: train_step(params, opt, b, 0), repeats=repeats)
    if mode != "decode":
        raise ValueError(f"unknown step mode {mode!r}")
    model, serve_step = make_serve_step(cfg, device=dev)
    params = model.init(gen)
    cache = model.init_cache(batch, seq)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return time_callable(lambda: serve_step(params, tok, cache, pos), repeats=repeats)


def step_analytic_seconds(arch: str, mode: str, device, *, batch: int = 2,
                          seq: int = 32) -> float:
    """Roofline prediction for the same step on ``device`` (a
    ``DeviceProfile``): planning-graph FLOPs at the step's geometry over
    the device's effective rate -- the number the planner would use."""
    from ..configs import reduced_config
    from ..models.registry import planning_graph

    cfg = reduced_config(arch)
    g = planning_graph(cfg, seq if mode == "train" else 1)
    fwd = sum(n.flops_fwd for n in g.nodes) * batch
    flops = 3.0 * fwd if mode == "train" else fwd
    return flops / device.effective_flops()


# -- multi-device: transfers + contended compute --------------------------------
def transfer_goodput(nbytes: int, *, repeats: int = 5,
                     fleet: Optional[Fleet] = None) -> float:
    """bytes/s of an explicit copy of ``nbytes`` from the first logical
    device to the second, into a preallocated buffer (needs >= 2 logical
    devices; ValueError otherwise). On one card this is a device-memory
    copy: a ``.to()`` onto the same card would copy nothing."""
    devs = _fleet(fleet).devices()
    if len(devs) < 2:
        raise ValueError("transfer benchmark needs >= 2 devices")
    n = max(nbytes // 4, 1)
    src = torch.zeros((n,), dtype=torch.float32, device=devs[0])
    dst = torch.empty((n,), dtype=torch.float32, device=devs[1])
    sec = time_callable(lambda: (dst.copy_(src), src)[0], repeats=repeats)
    return nbytes / sec


def contended_rate(n_devices: Optional[int] = None, *, dim: int = 512,
                   layers: int = 8, repeats: int = 3,
                   fleet: Optional[Fleet] = None) -> float:
    """Per-device FLOP/s when ``n_devices`` logical devices each run an
    identical tanh-MLP block stack, in turn, on their cards.

    On real edge fleets every device computes its pipeline stage at the
    same time; where the logical devices share one card, the rate a stage
    gets is the card's divided among them. This single measurement is the
    heart of the sim-to-real compute factor.
    """
    devs = _fleet(fleet).devices(n_devices)
    gen = torch.Generator(device=devs[0]).manual_seed(0)
    w = [(_randn(gen, (layers, dim, dim), devs[0]) * 0.1).to(d) for d in devs]
    x = [_randn(gen, (16, dim), devs[0]).to(d) for d in devs]

    def run():
        outs = []
        for wi, xi in zip(w, x):
            for layer in range(layers):
                xi = torch.tanh(xi @ wi[layer])
            outs.append(xi)
        return outs

    with full_f32():
        sec = time_callable(run, repeats=repeats)
    return 2.0 * layers * 16 * dim * dim / sec


def gated_mlp_layer(lp, x):
    """The fidelity proxy layer: a silu-gated MLP block -- 3 matmuls,
    ``6 * rows * d_model * d_ff`` FLOPs per call.  This is the exact
    ``layer_fn`` :mod:`repro_torch.calibrate.fidelity` hands the pipeline
    executor, so timing it under contention calibrates precisely the
    compute path the executed plan runs."""
    h = F.silu(x @ lp["wg"]) * (x @ lp["wu"])
    return h @ lp["wd"]


def init_gated_mlp(n_layers: int, d_model: int, d_ff: int,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Stacked (L, ...) float32 parameters for :func:`gated_mlp_layer`,
    scaled so activations neither explode nor vanish across the stack;
    drawn from ``gen``, on its device."""
    si, so = d_model ** -0.5, 1.8 * d_ff ** -0.5
    dev = gen.device
    return {
        "wg": _randn(gen, (n_layers, d_model, d_ff), dev) * si,
        "wu": _randn(gen, (n_layers, d_model, d_ff), dev) * si,
        "wd": _randn(gen, (n_layers, d_ff, d_model), dev) * so,
    }


def contended_mlp_rate(n_devices: Optional[int] = None, *, rows: int = 16,
                       d_model: int = 512, d_ff: int = 2048,
                       layers: int = 4, iters: int = 12,
                       training: bool = False,
                       repeats: int = 3, fleet: Optional[Fleet] = None) -> float:
    """Per-device FLOP/s of the gated-MLP proxy stage under ``n``-way
    load -- :func:`contended_rate` specialised to the fidelity loop's
    actual stage body, so the calibrated factor absorbs both the sharing
    of the card and the op-mix efficiency gap.

    The stage block runs ``iters`` times on every logical device in turn,
    each output handed to the next device -- the executor's ticks, each
    ending with its hand-off -- so per-call launch overhead is paid as the
    executor pays it.

    With ``training=True`` each stage call is checkpointed (the executor
    remats every stage) and the timed block is the loss and its backward:
    4x the forward FLOPs (forward + remat recompute + grad-x + grad-w),
    exactly the per-stage work mix of a pipelined training step.
    """
    devs = _fleet(fleet).devices(n_devices)
    n = len(devs)
    lp = init_gated_mlp(layers, d_model, d_ff, torch.Generator(device=devs[0]).manual_seed(0))
    lps = [{k: v.to(d) for k, v in lp.items()} for d in devs]
    gen = torch.Generator(device=devs[0]).manual_seed(1)
    x0 = [_randn(gen, (rows, d_model), devs[0]).to(d) for d in devs]

    def block(c, p):
        for layer in range(layers):
            c = gated_mlp_layer({k: v[layer] for k, v in p.items()}, c)
        return c

    def stack():
        xs = list(x0)
        for _ in range(iters):
            outs = [checkpoint(block, xs[i], lps[i], use_reentrant=False) if training
                    else block(xs[i], lps[i]) for i in range(n)]
            xs = [outs[i - 1].to(devs[i]) for i in range(n)]     # hand-off to the next
        return xs

    if training:
        leaves = [v.requires_grad_(True) for p in lps for v in p.values()]

        def run():
            loss = sum(torch.mean(y.to(devs[0]) ** 2) for y in stack())
            return torch.autograd.grad(loss, leaves)
        work = 4.0                       # fwd + remat recompute + 2x grad
    else:
        def run():
            with torch.no_grad():
                return stack()
        work = 1.0

    with full_f32():
        sec = time_callable(run, repeats=repeats)
    return work * 6.0 * rows * d_model * d_ff * layers * iters / sec


# -- cached driver ---------------------------------------------------------------
def measure_host(cache: Optional[MeasurementCache] = None, *,
                 archs=("qwen3_32b", "mamba2_780m"),
                 quick: bool = False) -> Dict[str, float]:
    """Run (or recall) the microbenchmark suite on the cache's fleet ->
    flat dict.

    Keys: ``matmul_peak_flops``, ``memory_bw``, ``kernel/<name>_flops``,
    ``step/<arch>/<mode>_s``, and -- when the logical fleet has more than
    one device -- ``transfer_large_bps``, ``transfer_small_bps``,
    ``contended_flops``, ``contended_mlp_flops``.
    """
    cache = cache if cache is not None else MeasurementCache()
    fleet = cache.fleet
    dev, n = fleet.device, fleet.n_devices
    rep = 2 if quick else 5
    dim = 512 if quick else 1024
    out: Dict[str, float] = {}
    out["matmul_peak_flops"] = cache.get_or_measure(
        "matmul_peak", f"d{dim}",
        lambda: matmul_peak_flops(dim, repeats=rep, device=dev))
    out["memory_bw"] = cache.get_or_measure(
        "memory_bw", "64MiB", lambda: memory_bandwidth(repeats=rep, device=dev))
    if not quick:
        names = ("flash_attention", "decode_attention", "ssd_scan",
                 "rglru_scan")
        cached = {k: cache.lookup(f"kernel_{k}", "default") for k in names}
        if any(v is None for v in cached.values()):
            cached = kernel_rates(repeats=3, device=dev)
            for k in names:
                cache.put(f"kernel_{k}", "default", cached[k])
        for k in names:
            out[f"kernel/{k}_flops"] = cached[k]
    for arch in archs:
        for mode in ("train", "decode"):
            out[f"step/{arch}/{mode}_s"] = cache.get_or_measure(
                f"step_{mode}", f"{arch}/b2s32",
                lambda a=arch, m=mode: step_seconds(a, m, repeats=rep, device=dev))
    if n > 1:
        out["transfer_large_bps"] = cache.get_or_measure(
            "transfer", "16MiB",
            lambda: transfer_goodput(1 << 24, repeats=rep, fleet=fleet))
        out["transfer_small_bps"] = cache.get_or_measure(
            "transfer", "64KiB",
            lambda: transfer_goodput(1 << 16, repeats=rep, fleet=fleet))
        out["contended_flops"] = cache.get_or_measure(
            "contended", f"n{n}/d512x8",
            lambda: contended_rate(repeats=rep, fleet=fleet))
        out["contended_mlp_flops"] = cache.get_or_measure(
            "contended_mlp", f"n{n}/r16/d512x2048/l4",
            lambda: contended_mlp_rate(repeats=rep, fleet=fleet))
    return out
