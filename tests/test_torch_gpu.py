"""The port's CUDA kernels on the card (marker ``gpu``; they skip without a
CUDA device). This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version: float32 on the
same inputs at atol/rtol 2e-5 (TF32 off); bfloat16 against the plain
version run in float32 on the same values, elementwise within
2**-5 * (|ref| + rms of ref's row over its last axis), which covers the
kernels' own roundings (P to bf16 in flash, the SSD scan's scores and
carried states, the output to bf16) several times over and stays well
below the size of a late output row. The SSD scan's final state is float32
whatever the input type and is held to the float32 tolerance.
"""
import dataclasses

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_RTOL = 2.0 ** -5
# The flash backward's bf16 outputs also get a floor of one bf16 step at the
# output's rms: causal row 0 of dq is exactly 0 (P = 1 on its one key and
# O = V there, so dP - D = 0), and the kernel's dP and D sum the same
# products in another order, leaving f32 noise against a row bound of 0.
BWD_FLOOR = 2.0 ** -9


def _assert_matches_plain(out, plain, *tensors):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, plain(*tensors), **F32_TOL)
        return
    _assert_within_bf16_bound(out, plain(*(t.float() for t in tensors)))


def _assert_within_bf16_bound(out, exp, floor=0.0):
    err = (out.float() - exp).abs()
    bound = BF16_RTOL * (exp.abs() + exp.pow(2).mean(dim=-1, keepdim=True).sqrt()) \
        + floor * exp.pow(2).mean().sqrt()
    assert bool((err <= bound).all()), (
        f"max abs err {float(err.max()):.3e}, worst element "
        f"{float((err / bound).nan_to_num(nan=0.0).max()):.3g} x its bound")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dtype):
    gen = _card()
    for (B, S, T, H, KV, d), causal, window in [
            ((2, 256, 256, 4, 2, 64), True, None),
            ((1, 384, 384, 8, 8, 128), True, 128),
            ((2, 200, 333, 4, 1, 128), False, None),
            ((1, 130, 130, 16, 4, 64), True, 40),
            ((2, 300, 300, 8, 2, 80), True, 100),      # h2o-danube-1.8b's head_dim, ragged
            ((1, 200, 333, 4, 1, 80), False, None),
            ((1, 256, 256, 48, 1, 128), True, None)]:  # granite-20b's 48 heads on 1 KV head
        q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        n0 = kernels.flash_attention.launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert kernels.flash_attention.launches == n0 + 1
        _assert_matches_plain(out, lambda q, k, v: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), q, k, v)


@pytest.mark.gpu
def test_flash_attention_bf16_head_dim_256_ragged_and_small_windows():
    """The wgmma path at head_dim 256 (recurrentgemma-9b), S and T off its
    128-row query tiles and 64/128-key tiles, windows narrower than a query
    tile, and non-causal at d = 256."""
    gen = _card()
    for (B, S, T, H, KV, d), causal, window in [
            ((1, 300, 300, 4, 1, 256), True, 100),
            ((2, 200, 333, 4, 2, 256), False, None),
            ((1, 1000, 1000, 2, 1, 256), True, 40),
            ((2, 333, 200, 4, 1, 128), False, None),
            ((1, 257, 257, 8, 2, 64), True, 40),
            ((1, 130, 130, 16, 4, 128), True, 100)]:
        q = torch.randn((B, S, H, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, T, KV, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, T, KV, d), generator=gen, device="cuda").bfloat16()
        n0 = kernels.flash_attention.launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert kernels.flash_attention.launches == n0 + 1
        _assert_matches_plain(out, lambda q, k, v: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(dtype):
    gen = _card()
    for (B, T, H, KV, d), lens, window in [
            ((4, 256, 4, 4, 64), [1, 17, 100, 256], None),
            ((3, 300, 8, 1, 128), [101, 300, 7], 96),
            ((2, 4128, 64, 8, 128), [4128, 3000], None),
            ((1, 64, 48, 1, 128), [0], None),           # no live key: zeros
            ((4, 2048, 16, 1, 256), [2048, 1793, 256, 1], None),   # recurrentgemma MQA ring
            ((3, 300, 8, 2, 256), [300, 101, 7], 96),
            ((4, 4128, 16, 2, 128), [4128, 1, 0, 4127], None),    # most splits empty
            ((3, 32, 8, 1, 64), [32, 5, 1], 8),                   # one split
            ((4, 4128, 32, 8, 80), [4128, 4097, 100, 0], None),   # h2o-danube-1.8b
            ((3, 300, 8, 2, 80), [300, 101, 7], 96),
            ((4, 4128, 48, 1, 128), [4128, 4000, 17, 1], None),   # granite-20b's G = 48
            ((2, 64, 8, 2, 16), [64, 33], None),        # the reduced dense configs' d = 16
            ((3, 300, 8, 2, 16), [300, 101, 0], 96)]:
        if T == 32:
            assert kernels.decode_attention.split_plan(T, B, KV, H // KV)[1] == 1
        q = torch.randn((B, 1, H, d), generator=gen, device="cuda").to(dtype)
        kc = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        vc = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n0 = kernels.decode_attention.launches
        out = ops.decode_attention(q, kc, vc, cl, window=window)
        torch.cuda.synchronize()
        assert kernels.decode_attention.launches == n0 + 1
        live = [i for i, n in enumerate(lens) if n > 0]
        assert not out[[i for i, n in enumerate(lens) if n == 0]].any()   # no live key: zeros
        if live:
            _assert_matches_plain(out[live], lambda q, kc, vc: ref.decode_attention_ref(
                q, kc, vc, cl[live], window=window), q[live], kc[live], vc[live])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(dtype):
    gen = _card()
    for B, S, H, P, G, N, chunk in [(2, 512, 4, 64, 1, 128, 128), (1, 256, 8, 32, 2, 64, 64),
                                    (1, 300, 4, 64, 1, 32, 100), (2, 64, 8, 32, 1, 16, 32)]:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda") * 0.1
        x, b, c = rand(B, S, H, P).to(dtype), rand(B, S, G, N).to(dtype), rand(B, S, G, N).to(dtype)
        a = -rand(B, S, H).abs()
        n0 = kernels.ssd_scan.launches
        y, state = ops.ssd_scan(x, a, b, c, chunk=chunk)
        torch.cuda.synchronize()
        assert kernels.ssd_scan.launches == n0 + 1
        assert y.dtype == dtype and state.dtype == torch.float32
        _assert_matches_plain(y, lambda x, b, c: ref.ssd_scan_ref(x, a, b, c, chunk)[0], x, b, c)
        torch.testing.assert_close(state, ref.ssd_scan_ref(x.float(), a, b.float(), c.float(),
                                                           chunk)[1], **F32_TOL)


def _ssd_inputs(gen, B, S, H, P, G, N, dtype):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.1
    x, b, c = rand(B, S, H, P).to(dtype), rand(B, S, G, N).to(dtype), rand(B, S, G, N).to(dtype)
    return x, -rand(B, S, H).abs(), b, c


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 512, 4, 64, 1, 128, 256),     # mamba2-780m's head and state sizes
    (1, 256, 8, 32, 2, 64, 64),       # two groups
    (1, 300, 4, 64, 1, 32, 100),      # a chunk off the 64-row tiles
    (2, 64, 8, 16, 1, 16, 32),        # the smallest P and N
    (1, 96, 2, 48, 1, 80, 48)])       # P and N that leave some warp tiles part empty
def test_ssd_bf16_stage_kernels_match_their_plain_stages(B, S, H, P, G, N, chunk):
    """Each bf16 stage kernel against its plain stage function on the same
    inputs (the plain stages' outputs feed the next kernel): cb, the chunk
    states, a_cum and the final state at the float32 tolerance; prev (bf16)
    and y at the bf16 bound."""
    gen = _card()
    x, a, b, c = _ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16)
    nc, lp = S // chunk, -(-chunk // 64) * 64
    cb_exp = ssd.ssd_cb(b, c, chunk)
    tile = torch.arange(chunk, device="cuda") // 64
    lower = tile[None, :] <= tile[:, None]               # the 64x64 tiles the kernel writes
    cb = ssd.cb_kernel(b, c, chunk)
    assert cb.shape == (B, nc, G, lp, lp)
    torch.testing.assert_close(cb[..., :chunk, :chunk][..., lower], cb_exp[..., lower],
                               **F32_TOL)
    states, a_cum = ssd.chunk_state_kernel(x, a, b, chunk)
    states_exp, a_cum_exp = ssd.ssd_chunk_state(x, a, b, chunk)
    torch.testing.assert_close(a_cum, a_cum_exp, **F32_TOL)
    torch.testing.assert_close(states, states_exp, **F32_TOL)
    prev, final = ssd.state_passing_kernel(states_exp, a_cum_exp)
    prev_exp, final_exp = ssd.ssd_state_passing(states_exp, a_cum_exp)
    assert prev.dtype == torch.bfloat16 and final.dtype == torch.float32
    _assert_within_bf16_bound(prev, prev_exp)
    torch.testing.assert_close(final, final_exp, **F32_TOL)
    cb_pad = torch.zeros((B, nc, G, lp, lp), device="cuda")
    cb_pad[..., :chunk, :chunk] = cb_exp
    prev_bf = prev_exp.bfloat16()
    y = ssd.chunk_scan_kernel(x, a_cum_exp, c, cb_pad, prev_bf)
    assert y.dtype == torch.bfloat16
    _assert_within_bf16_bound(y, ssd.ssd_chunk_scan(x.float(), a_cum_exp, c, cb_exp, prev_bf))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_ssd_scan_bf16_at_mamba2_prefill_shape():
    """The bf16 path at mamba2-780m's prefill shape with B = 1: y at the bf16
    bound, the final state at the float32 tolerance."""
    gen = _card()
    x, a, b, c = _ssd_inputs(gen, 1, 4096, 48, 64, 1, 128, torch.bfloat16)
    n0 = kernels.ssd_scan.launches
    y, state = ops.ssd_scan(x, a, b, c, chunk=256)
    torch.cuda.synchronize()
    assert kernels.ssd_scan.launches == n0 + 1
    y_exp, state_exp = ref.ssd_scan_ref(x.float(), a, b.float(), c.float(), 256)
    _assert_within_bf16_bound(y, y_exp)
    torch.testing.assert_close(state, state_exp, **F32_TOL)


@pytest.mark.gpu
def test_rglru_scan_kernel_matches_plain():
    gen = _card()
    for B, S, W in [(2, 512, 256), (1, 384, 128), (3, 77, 96), (4, 2048, 4096)]:
        a = -torch.randn((B, S, W), generator=gen, device="cuda").abs() * 0.5
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        n0 = kernels.rglru_scan.launches
        h, h_last = kernels.rglru_scan.rglru_scan(a, b)
        torch.cuda.synchronize()
        assert kernels.rglru_scan.launches == n0 + 1
        he, hle = ref.rglru_scan_ref(a, b)
        torch.testing.assert_close(h, he, **F32_TOL)
        torch.testing.assert_close(h_last, hle, **F32_TOL)


@pytest.mark.gpu
def test_rglru_prefill_launches_the_kernel_at_any_length():
    """apply_rglru from zero state takes the kernel on the card at a length
    and width off the TPU kernel's (256, 512) tiling (S = 300, W = 640), and
    agrees with the same block on the CPU."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import rglru

    gen = _card()
    cfg = dataclasses.replace(reduced_config("recurrentgemma_9b"), lru_width=640)
    p = rglru.init_rglru(gen, cfg, torch.float32)
    x = torch.randn((2, 300, cfg.d_model), generator=gen, device="cuda")
    n0 = kernels.rglru_scan.launches
    out, state = rglru.apply_rglru(p, x, cfg)
    torch.cuda.synchronize()
    assert kernels.rglru_scan.launches == n0 + 1
    out_c, state_c = rglru.apply_rglru({k: v.cpu() for k, v in p.items()}, x.cpu(), cfg)
    assert kernels.rglru_scan.launches == n0 + 1
    torch.testing.assert_close(out.cpu(), out_c, atol=1e-4, rtol=1e-4)
    for k in ("lru", "conv"):
        torch.testing.assert_close(state[k].cpu(), state_c[k], atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    _card()
    q = torch.zeros((1, 16, 4, 96), device="cuda")             # head_dim 96: no kernel takes it
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q[..., :64].half(), q[..., :64].half(), q[..., :64].half())
    q256 = torch.zeros((1, 16, 4, 256), device="cuda")         # float32 takes 64 and 128 only
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q256, q256, q256)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q[:, :1], q, q, torch.ones(1, dtype=torch.int32, device="cuda"))
    x, a, bc = (torch.zeros((1, 96, 4, 64), device="cuda"), torch.zeros((1, 96, 4), device="cuda"),
                torch.zeros((1, 96, 1, 32), device="cuda"))
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd_scan(x.half(), a, bc.half(), bc.half(), chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, a, bc, bc, chunk=64)                   # 96 % 64 != 0
    with pytest.raises(ValueError, match="P=80"):
        ops.ssd_scan(torch.zeros((1, 96, 4, 80), device="cuda"), a, bc, bc, chunk=32)
    with pytest.raises(ValueError, match="dtype"):
        kernels.rglru_scan.rglru_scan(a.bfloat16(), a.bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dtype):
    """The backward kernels against flash_attention_bwd_ref on the same
    inputs (the forward kernel's output and log-sum-exp): causal and
    windowed, G = 1, 4, 8 and 48, ragged S, head_dim 64, 80 and 128, the
    query group split across blocks (G = 48 at S = 1024 with and without a
    window, and one key tile of a ragged S, where every block is one split);
    the forward's log-sum-exp against the plain one."""
    gen = _card()
    for (B, S, H, KV, d), window in [((2, 256, 4, 4, 64), None), ((1, 300, 8, 2, 128), None),
                                     ((1, 333, 8, 1, 64), 100), ((2, 130, 16, 2, 128), 40),
                                     ((1, 300, 8, 2, 80), 100), ((2, 256, 32, 8, 80), None),
                                     ((1, 256, 48, 1, 128), None), ((1, 1024, 48, 1, 128), None),
                                     ((1, 1024, 48, 1, 128), 300), ((1, 777, 16, 2, 80), 300),
                                     ((2, 555, 8, 2, 64), 200), ((1, 100, 8, 1, 128), None)]:
        if (S, H) == (1024, 48) or S == 100:
            assert kernels.flash_attention.bwd_split_plan(B, S, KV, H // KV) > 1
        q, k, v = (torch.randn((B, S, n, d), generator=gen, device="cuda").to(dtype)
                   for n in (H, KV, KV))
        dout = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
        n0 = kernels.flash_attention.launches
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
        exp_lse = ref.flash_attention_lse_ref(q.float(), k.float(), causal=True, window=window)
        torch.testing.assert_close(lse, exp_lse, atol=1e-4 if dtype == torch.bfloat16 else 2e-5,
                                   rtol=2e-5)
        b0 = kernels.flash_attention.bwd_launches
        got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=window)
        torch.cuda.synchronize()
        assert kernels.flash_attention.launches == n0 + 1
        assert kernels.flash_attention.bwd_launches == b0 + 1
        plain = [t.float() for t in (q, k, v, out)] + [lse, dout.float()]
        exp = ref.flash_attention_bwd_ref(*plain, causal=True, window=window)
        for g, e in zip(got, exp):
            assert g.dtype == dtype
            if dtype == torch.float32:
                torch.testing.assert_close(g, e, **F32_TOL)
            else:     # plus a floor of one bf16 step at the output's rms (see BWD_FLOOR)
                _assert_within_bf16_bound(g, e, BWD_FLOOR)


@pytest.mark.gpu
def test_flash_attention_autograd_on_card_runs_both_kernels():
    gen = _card()
    q, k, v = (torch.randn((1, 200, n, 64), generator=gen, device="cuda").requires_grad_(True)
               for n in (8, 2, 2))
    n0, b0 = kernels.flash_attention.launches, kernels.flash_attention.bwd_launches
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert kernels.flash_attention.launches == n0 + 1
    assert kernels.flash_attention.bwd_launches == b0 + 1
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    exp = torch.autograd.grad(ref.flash_attention_ref(qc, kc, vc).square().sum(), (qc, kc, vc))
    for g, e in zip(grads, exp):
        torch.testing.assert_close(g.cpu(), e, atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):     # no backward at d = 256
        q256 = torch.zeros((1, 16, 2, 256), device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
        ops.flash_attention(q256, q256.detach(), q256.detach())


@pytest.mark.gpu
def test_kernels_without_backward_refuse_grad():
    """decode_attention and rglru_scan have no backward on the card: a call
    that needs a gradient raises instead of dropping it (ssd_scan has one
    since its backward kernel came)."""
    _card()
    q = torch.zeros((1, 1, 4, 64), device="cuda", requires_grad=True)
    kc = torch.zeros((1, 32, 4, 64), device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.decode_attention(q, kc, kc, lens)
    a = torch.zeros((1, 64, 4), device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.rglru_scan(a.requires_grad_(True), a.detach())
    with torch.no_grad():                              # without grad they run
        ops.decode_attention(q, kc, kc, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_kernel_matches_plain(dtype):
    """The backward kernels against ssd_scan_bwd_ref on the same values:
    the reduced mamba2 train step's shape, kernel_rates', grouped, a group
    a head with chunk 100, and mamba2-780m's heads at chunk 256; with and
    without the final state's cotangent. da_log (float32 whatever the
    input type) is held to the float32 tolerance."""
    gen = _card()
    for (B, S, H, P, G, N, chunk), with_state in [
            ((2, 64, 8, 32, 1, 16, 32), False), ((1, 256, 4, 64, 1, 64, 128), True),
            ((1, 192, 8, 32, 2, 32, 64), True), ((1, 300, 4, 16, 4, 16, 100), True),
            ((1, 512, 4, 64, 1, 128, 256), False)]:
        x = (torch.randn((B, S, H, P), generator=gen, device="cuda") * 0.1).to(dtype)
        a = -torch.randn((B, S, H), generator=gen, device="cuda").abs() * 0.1
        b, c = ((torch.randn((B, S, G, N), generator=gen, device="cuda") * 0.1).to(dtype)
                for _ in range(2))
        dy = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
        dst = torch.randn((B, H, P, N), generator=gen, device="cuda") if with_state else None
        b0 = ssd.bwd_launches
        got = ops.ssd_scan_bwd(x, a, b, c, dy, dst, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd.bwd_launches == b0 + 1
        exp = ref.ssd_scan_bwd_ref(x.float(), a, b.float(), c.float(), dy.float(), dst, chunk)
        for name, g, e, t in zip(("dx", "da", "db", "dc"), got, exp, (x, a, b, c)):
            assert g.dtype == t.dtype and g.shape == t.shape, name
            if g.dtype == torch.float32:
                torch.testing.assert_close(g, e, **F32_TOL)
            else:
                _assert_within_bf16_bound(g, e)


@pytest.mark.gpu
def test_ssd_scan_autograd_on_card_runs_both_kernels():
    """Autograd through ops.ssd_scan on the card (forward kernel, then the
    backward kernels) against autograd through the plain version on the
    CPU."""
    gen = _card()
    shapes = ((2, 64, 8, 32), (2, 64, 8), (2, 64, 1, 16), (2, 64, 1, 16))
    xs = [torch.randn(s, generator=gen, device="cuda") * 0.1 for s in shapes]
    xs[1] = -xs[1].abs()
    xs = [t.requires_grad_(True) for t in xs]
    n0, b0 = ssd.launches, ssd.bwd_launches
    y, state = ops.ssd_scan(*xs, chunk=32)
    grads = torch.autograd.grad(y.square().sum() + state.sum(), xs)
    assert (ssd.launches, ssd.bwd_launches) == (n0 + 1, b0 + 1)
    cs = [t.detach().cpu().requires_grad_(True) for t in xs]
    yc, sc = ref.ssd_scan_ref(*cs, 32)
    exp = torch.autograd.grad(yc.square().sum() + sc.sum(), cs)
    for g, e in zip(grads, exp):
        torch.testing.assert_close(g.cpu(), e, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,with_state", [
    (2, 512, 4, 64, 1, 128, 256, False),   # mamba2-780m's head and state sizes
    (2, 512, 8, 32, 2, 64, 128, True),     # two groups of four heads
    (1, 300, 4, 64, 4, 32, 100, True),     # a group a head, a chunk off the 64-row tiles
    (2, 64, 8, 16, 1, 16, 32, False),      # the smallest P and N
    (1, 96, 2, 48, 1, 80, 48, True),       # P and N that leave some warp tiles part empty
    (1, 300, 2, 32, 1, 32, 150, True)])    # three 64-row tiles: a half-empty 128-row block
def test_ssd_bwd_bf16_stage_kernels_match_their_plain_stages(B, S, H, P, G, N, chunk,
                                                             with_state):
    """Each bf16 backward stage kernel against its plain stage on the same
    inputs (the plain stages' outputs feed the next kernel): a_cum, the
    chunk states, d_prev, prev and dst (summed over their bf16 planes),
    d_last, cbT, d_intra and d_state (summed over their slots) and da at the
    float32 tolerance; dcbT, dx, db and dc at the bf16 bound."""
    gen = _card()
    x, a, b, c = _ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16)
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda").bfloat16()
    dst = torch.randn((B, H, P, N), generator=gen, device="cuda") if with_state else None
    xf, bf, cf, dyf = x.float(), b.float(), c.float(), dy.float()
    nc, lp = S // chunk, -(-chunk // 64) * 64
    states_e, d_prev_e, a_cum_e = (t.contiguous() for t in ssd.ssd_bwd_chunk_state(
        xf, a, bf, cf, dyf, chunk))
    states, d_prev, a_cum = ssd.bwd_chunk_state_kernel(x, a, b, c, dy, chunk)
    for got, exp in ((states, states_e), (d_prev, d_prev_e), (a_cum, a_cum_e)):
        torch.testing.assert_close(got, exp, **F32_TOL)
    prev_e, dst_e, d_last_e = ssd.ssd_bwd_state_passing(states_e, d_prev_e, a_cum_e, dst)
    prev3, dst3, d_last = ssd.bwd_state_passing_kernel(states_e, d_prev_e, a_cum_e, dst)
    assert prev3.shape == (B, nc, H, 3, P, N) and prev3.dtype == torch.bfloat16
    torch.testing.assert_close(prev3.float().sum(-3), prev_e, **F32_TOL)
    torch.testing.assert_close(dst3.float().sum(-3), dst_e, **F32_TOL)
    torch.testing.assert_close(d_last.sum(-1), d_last_e, **F32_TOL)
    cb_e, dcb_e, d_intra_e = ssd.ssd_bwd_dcb(xf, dyf, bf, cf, a_cum_e, chunk)
    cbT, dcbT, d_intra = ssd.bwd_dcb_kernel(x, dy, b, c, a_cum_e)
    tile = torch.arange(chunk, device="cuda") // 64
    upper = tile[None, :] >= tile[:, None]               # the [j][i] tiles the kernel writes
    torch.testing.assert_close(cbT[..., :chunk, :chunk][..., upper],
                               cb_e.transpose(-1, -2)[..., upper], **F32_TOL)
    _assert_within_bf16_bound(torch.where(upper, dcbT[..., :chunk, :chunk].float(), 0.0),
                              dcb_e.transpose(-1, -2))
    torch.testing.assert_close(d_intra.sum(3)[..., :chunk], d_intra_e, **F32_TOL)
    cb_pad = torch.zeros((B, nc, G, lp, lp), device="cuda")
    cb_pad[..., :chunk, :chunk] = cb_e.transpose(-1, -2)
    dst3_e, prev3_e = ssd.split_bf16(dst_e).contiguous(), ssd.split_bf16(prev_e).contiguous()
    dx = ssd.bwd_dx_kernel(dy, b, a_cum_e, cb_pad, dst3_e)
    _assert_within_bf16_bound(dx, ssd.ssd_bwd_dx(dyf, bf, a_cum_e, cb_e, dst_e))
    dcb_pad = torch.zeros((B, nc, G, lp, lp), device="cuda", dtype=torch.bfloat16)
    dcb_pad[..., :chunk, :chunk] = dcb_e.transpose(-1, -2).bfloat16()
    db, dc, d_state = ssd.bwd_dbdc_kernel(x, dy, b, c, a_cum_e, dcb_pad, prev3_e, dst3_e)
    db_e, dc_e, d_state_e = ssd.ssd_bwd_dbdc(xf, dyf, bf, cf, a_cum_e, dcb_e, prev_e, dst_e)
    _assert_within_bf16_bound(db, db_e)
    _assert_within_bf16_bound(dc, dc_e)
    torch.testing.assert_close(d_state.sum(3)[..., :chunk], d_state_e, **F32_TOL)
    d_intra_pad = torch.zeros((B, H, nc, lp // 64, lp), device="cuda")
    d_intra_pad[:, :, :, 0, :chunk] = d_intra_e
    d_state_pad = torch.zeros((B, H, nc, 2, lp), device="cuda")
    d_state_pad[:, :, :, 0, :chunk] = d_state_e
    d_last_pad = torch.zeros((B, H, nc, ssd.bwd_slices(P, N)), device="cuda")
    d_last_pad[..., 0] = d_last_e
    da = ssd.bwd_da_kernel(d_intra_pad, d_state_pad, d_last_pad, P, N, chunk)
    torch.testing.assert_close(da, ssd.ssd_bwd_da(d_intra_e, d_state_e, d_last_e), **F32_TOL)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_ssd_scan_bwd_bf16_db_dc_are_bit_reproducible():
    """The bf16 backward sums db and dc over a group's heads in a fixed
    order (no atomics): two calls on the same inputs give the same bits, in
    every output."""
    gen = _card()
    x, a, b, c = _ssd_inputs(gen, 2, 512, 8, 64, 2, 128, torch.bfloat16)
    dy = torch.randn((2, 512, 8, 64), generator=gen, device="cuda").bfloat16()
    dst = torch.randn((2, 8, 64, 128), generator=gen, device="cuda")
    first = ops.ssd_scan_bwd(x, a, b, c, dy, dst, chunk=256)
    second = ops.ssd_scan_bwd(x, a, b, c, dy, dst, chunk=256)
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)


@pytest.mark.gpu
def test_calibration_microbenchmarks_launch_the_kernels():
    """kernel_rates on the card launches each of the four kernels; the
    reduced mamba2 train step launches the SSD scan's forward and backward,
    the reduced qwen3 decode step the d = 16 decode kernel."""
    from repro_torch.calibrate import microbench
    _card()
    kernels.reset_launches()
    rates = microbench.kernel_rates(repeats=1)
    counts = kernels.launch_counts()
    assert all(v > 0 for v in rates.values())
    for name in ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan"):
        assert counts[name] > 0, (name, counts)
    kernels.reset_launches()
    assert microbench.step_seconds("mamba2_780m", "train", repeats=1) > 0
    assert kernels.launch_counts()["ssd_scan_bwd"] > 0
    kernels.reset_launches()
    assert microbench.step_seconds("qwen3_32b", "decode", repeats=1) > 0
    assert kernels.launch_counts()["decode_attention"] > 0


@pytest.mark.gpu
def test_small_train_step_card_matches_cpu():
    """One float32 train step of a small qwen3-family model (head_dim 64,
    attn_chunk 64 < S = 256, so the flash forward and backward kernels run)
    on the card against the same step on the CPU: loss and grad_norm within
    1e-4 relative, and the flash kernels launched on every layer."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    _card()
    cfg = dataclasses.replace(reduced_config("qwen3_32b"), head_dim=64, n_layers=2,
                              attn_chunk=64)
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev in ("cpu", "cuda"):
        _, step = make_train_step(cfg, peak_lr=1e-3, warmup=2, total=10, device=dev)
        p = _to(params, dev)
        kernels.reset_launches()
        _, _, out[dev] = step(p, adamw_init(p), _to(batch, dev), 1)
        out[dev + "_launches"] = kernels.launch_counts()
    for key in ("loss", "grad_norm"):
        assert float(out["cuda"][key]) == pytest.approx(float(out["cpu"][key]), rel=1e-4)
    assert out["cpu_launches"]["flash_attention"] == 0
    assert out["cuda_launches"]["flash_attention"] == 4       # forward + recompute, 2 layers
    assert out["cuda_launches"]["flash_attention_bwd"] == 2


def _to(tree, device):
    """A copy on ``device``, also on the same device: the train step
    updates its parameters in place."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


@pytest.mark.gpu
def test_pipeline_executor_on_card_matches_sequential():
    """The pipeline executor on the card (4 stages of 1/3/2/2 small h2o-family
    float32 layers, attn_chunk 64 < S = 128 so the flash kernels run, 4
    microbatches of 2) against the same layers applied one after another
    on the card: forward and gradients at 1e-5 of each leaf's largest
    magnitude, the padded slots' gradients exactly zero, and the flash
    launches of the remat'd stages exact (forward and recompute, one
    backward, a layer and microbatch)."""
    from repro_torch.configs import reduced_config
    from repro_torch.core import ParallelismPlan, Stage
    from repro_torch.models import build_model
    from repro_torch.models.transformer import apply_block
    from repro_torch.runtime.pipeline import DoraPipelineExecutor

    _card()
    cfg = dataclasses.replace(reduced_config("h2o_danube_1_8b"), head_dim=80, n_layers=8,
                              attn_chunk=64, window=96)
    stacked = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(1))["stack"]["u0"]
    stages, lo = [], 0
    for s, n in enumerate([1, 3, 2, 2]):
        stages.append(Stage(node_ids=list(range(lo, lo + n)), devices=[s],
                            microbatch_split={s: 1.0}))
        lo += n
    plan = ParallelismPlan(stages=stages, microbatch_size=2, n_microbatches=4)
    layer_fn = lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train")  # noqa: E731
    ex = DoraPipelineExecutor(plan, cfg.n_layers, layer_fn)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4, 2, 128, cfg.d_model), generator=g, device="cuda")
    r = torch.randn(x.shape, generator=g, device="cuda")
    packed = ex.pack_params(stacked)

    def leaves(tree):
        return [t for v in tree.values() for t in (leaves(v) if isinstance(v, dict) else [v])]

    def rebuild(tree, it):
        return {k: rebuild(v, it) if isinstance(v, dict) else next(it) for k, v in tree.items()}
    p_leaves = [t.clone().requires_grad_(True) for t in leaves(packed)]
    kernels.reset_launches()
    loss = ex.loss(rebuild(packed, iter(p_leaves)), x, lambda o: (o * r).sum())
    grads = torch.autograd.grad(loss, p_leaves)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers * 4
    assert counts["flash_attention_bwd"] == cfg.n_layers * 4

    s_leaves = [t.clone().requires_grad_(True) for t in leaves(stacked)]
    s_tree = rebuild(stacked, iter(s_leaves))
    ys = []
    for m in range(4):
        y = x[m]
        for i in range(cfg.n_layers):
            y = layer_fn({k: (v[i] if not isinstance(v, dict) else {kk: vv[i] for kk, vv in
                                                                  v.items()})
                          for k, v in s_tree.items()}, y)
        ys.append(y)
    ref = torch.stack(ys)
    ref_grads = torch.autograd.grad((ref * r).sum(), s_leaves)
    with torch.no_grad():
        out = ex.forward(packed, x)
    ref = ref.detach()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    for g_p, g_s in zip(grads, ref_grads):
        got = ex.unpack_params(g_p)
        assert float((got - g_s).abs().max()) <= 1e-5 * float(g_s.abs().max())
        for s, n in enumerate(ex.spec.layers_per_stage):
            assert bool((g_p[s, n:] == 0).all())


@pytest.mark.gpu
def test_catalogue_plan_replanned_by_the_control_plane_runs_on_card():
    """granite-8b planned on vehicle_platoon through ``dora.serve`` (the
    serve launcher's workload and QoE), each event of the scenario's
    timeline fed to the control plane (a replan each, as in the JAX
    package), then the plan the session holds run through the executor on
    the card at full width and 8 of 36 layers (bf16, 4 microbatches of 1 x
    1024, attn_chunk 512 so the flash kernel runs): bitwise equal to the
    same layers applied in plain order, one flash launch a layer and
    microbatch."""
    from repro_torch import dora
    from repro_torch.configs import get_config
    from repro_torch.core import QoESpec, Workload
    from repro_torch.models import build_model
    from repro_torch.models.registry import planning_graph
    from repro_torch.models.transformer import apply_block
    from repro_torch.runtime.pipeline import DoraPipelineExecutor
    from repro_torch.scenarios import get_scenario

    _card()
    full = get_config("granite_8b")
    session = dora.serve("vehicle_platoon", graph=planning_graph(full, 4096),
                         qoe=QoESpec(t_qoe=0.2, lam=100.0),
                         workload=Workload(global_batch=4, microbatch_size=1, training=False))
    timeline = get_scenario("vehicle_platoon").timeline
    assert [session.on_dynamics(ev)[1] for _, ev in timeline] == ["replan"] * len(timeline)
    plan = session.current
    assert [len(s.node_ids) for s in plan.stages] == [10, 28]
    cfg = dataclasses.replace(full, n_layers=8, attn_chunk=512)
    layer_fn = lambda lp, x: apply_block(lp, x, cfg, "dense", mode="train")  # noqa: E731
    ex = DoraPipelineExecutor(plan, cfg.n_layers, layer_fn)
    assert ex.spec.layers_per_stage == (2, 6)
    M, S = ex.spec.n_microbatches, 1024
    params = build_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (M, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    stack = params["stack"]["u0"]

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
    with torch.no_grad():
        x = params["embed"][toks].view(M, 1, S, cfg.d_model)
        ref = []
        for m in range(M):
            y = x[m]
            for i in range(cfg.n_layers):
                y = layer_fn(layer(stack, i), y)
            ref.append(y)
        ref = torch.stack(ref)
        packed = ex.pack_params(stack)
        kernels.reset_launches()
        out = ex.forward(packed, x)
        torch.cuda.synchronize()
    assert str(out.dtype) == f"torch.{cfg.dtype}" and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref)
    want = {k: 0 for k in kernels.KERNELS}
    want["flash_attention"] = cfg.n_layers * M
    assert kernels.launch_counts() == want
