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
    cases = [((4, 256, 4, 4, 64), [1, 17, 100, 256], None),
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
             ((3, 300, 8, 2, 16), [300, 101, 0], 96)]
    assert kernels.decode_attention.split_plan(32, 3, 1, 8)[1] == 1      # "one split"
    _check_decode(gen, dtype, cases)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_whisper_and_paligemma_shapes(dtype):
    """whisper-small's decoder self-attention (head_dim 64, 12 heads on 12 KV
    heads: G = 1) and paligemma-3b's (head_dim 256, 8 heads on one KV head:
    G = 8) at their served caches (224 + 32 and 256 + 128 + 32 slots) and at
    batch 1 part-filled."""
    _check_decode(_card(), dtype, [
        ((4, 256, 12, 12, 64), [256, 225, 17, 0], None),
        ((1, 241, 12, 12, 64), [240], None),
        ((4, 416, 8, 1, 256), [416, 257, 100, 0], None),
        ((1, 401, 8, 1, 256), [400], None)])


def _check_decode(gen, dtype, cases):
    """Each ((B, T, H, KV, d), lens, window) case: one launch, zeros where no
    key is live, the rest against the plain version."""
    for (B, T, H, KV, d), lens, window in cases:
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
    """a_log = -0.5 |N(0, 1)|: recurrentgemma-9b's prefill and training
    shapes, S off the kernel's 128-step rounds, S = 1, W off its 32-channel
    tile; float32 at 2e-5."""
    gen = _card()
    for B, S, W in [(2, 512, 256), (1, 384, 128), (3, 77, 96), (4, 2048, 4096), (2, 4096, 4096),
                    (1, 1, 200), (2, 9, 200)]:
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
@pytest.mark.parametrize("decay", [1e-3, 0.0])
def test_rglru_scan_kernel_carries_the_state(decay):
    """Decay near one (a_log = -1e-3 |N(0, 1)|) and none (a_log = 0, h the
    running sum of b) keep a state across the kernel's 128-step rounds. The
    kernel and the plain version are held to a float64 run of the
    recurrence on the same float32 decays exp(a_log), at 2e-5 of (|h| + the
    channel's rms over the sequence): such an h crosses zero while its
    float32 error grows with the channel's size, and the card's float32 exp
    rounds up on average near 0 (~0.25 ulp on an H100), which over ~1000
    steps moves both alike by about that bound. At chip_smoke.py's
    ``RG_CARRY_SHAPES``: the training shape, off a whole round, shorter
    than a piece, S = 1, W off the tile and B = 1. Two launches give the
    same bits, and h_last is h's last step."""
    gen = _card()
    cs, _ = _chip_smoke()
    for _, (B, S, W) in cs.RG_CARRY_SHAPES:
        a = -torch.randn((B, S, W), generator=gen, device="cuda").abs() * decay
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        h, h_last = kernels.rglru_scan.rglru_scan(a, b)
        h64, last64 = cs.rglru_f64(torch, torch.exp(a), b)
        rms = h64.pow(2).mean(dim=1).sqrt()
        for got, got_last in ((h, h_last), ref.rglru_scan_ref(a, b)):
            assert cs.carry_share(torch, got, h64, rms[:, None])[1] <= 1.0, (B, S, W)
            assert cs.carry_share(torch, got_last, last64, rms)[1] <= 1.0, (B, S, W)
        h2, h_last2 = kernels.rglru_scan.rglru_scan(a, b)
        assert torch.equal(h, h2) and torch.equal(h_last, h_last2)
        assert torch.equal(h_last, h[:, -1])


@pytest.mark.gpu
def test_rglru_scan_bwd_kernel_matches_plain():
    """rglru_scan_bwd against rglru_scan_bwd_ref on the same values (the
    forward kernel's h): recurrentgemma-9b's training shape, S off the
    kernel's 16-step groups, W off its 128-channel blocks, with and without
    dh_last and without dh; float32 at 2e-5."""
    gen = _card()
    for (B, S, W), with_dh, with_last in [((2, 4096, 4096), True, False),
                                          ((2, 300, 256), True, True), ((3, 77, 200), True, False),
                                          ((2, 64, 128), False, True), ((1, 5, 128), True, True)]:
        a = -torch.randn((B, S, W), generator=gen, device="cuda").abs() * 0.5
        b = torch.randn((B, S, W), generator=gen, device="cuda")
        h, _ = kernels.rglru_scan.rglru_scan(a, b)
        dh = torch.randn((B, S, W), generator=gen, device="cuda") if with_dh else None
        dl = torch.randn((B, W), generator=gen, device="cuda") if with_last else None
        n0 = kernels.rglru_scan.bwd_launches
        got = ops.rglru_scan_bwd(a, h, dh, dl)
        torch.cuda.synchronize()
        assert kernels.rglru_scan.bwd_launches == n0 + 1
        for g, e in zip(got, ref.rglru_scan_bwd_ref(a, h, dh, dl)):
            torch.testing.assert_close(g, e, **F32_TOL)


@pytest.mark.gpu
def test_rglru_scan_fn_gradients_match_autograd_on_cpu():
    """Through RglruScanFn (the forward and backward kernels) the gradients
    of a loss of h and of h_last, of h alone (h_last's cotangent left out)
    and of h_last alone match autograd through the plain scan on the CPU."""
    gen = _card()
    a0 = -torch.randn((2, 200, 160), generator=gen, device="cuda").abs() * 0.5
    b0 = torch.randn((2, 200, 160), generator=gen, device="cuda")
    for use_h, use_last in ((True, True), (True, False), (False, True)):
        grads = []
        for dev in ("cuda", "cpu"):
            a, b = (t.to(dev).requires_grad_(True) for t in (a0, b0))
            h, hl = ops.rglru_scan(a, b)
            loss = (h.square().sum() if use_h else 0) + (hl.sum() if use_last else 0)
            grads.append([g.cpu() for g in torch.autograd.grad(loss, (a, b))])
        for g, e in zip(*grads):
            torch.testing.assert_close(g, e, atol=1e-4, rtol=1e-4)


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
def test_flash_attention_bf16_bwd_head_dim_256_ragged_and_windowed():
    """The bf16 backward at head_dim 256 (its own 64-key instance) against
    flash_attention_bwd_ref in float32 on the same values, within the bf16
    bound plus BWD_FLOOR: recurrentgemma-9b's 16 heads on one KV head with
    its 2048 window at S = 4096 (the training shape at B = 1, split in four),
    a ragged S, a small window, two KV heads, and one key tile whose group
    the split plan spreads over every head."""
    gen = _card()
    fa = kernels.flash_attention
    for (B, S, H, KV), window in [((1, 4096, 16, 1), 2048), ((2, 333, 8, 1), None),
                                  ((1, 1000, 16, 1), 40), ((1, 200, 4, 2), 100),
                                  ((1, 64, 16, 1), None)]:
        q, k, v = (torch.randn((B, S, n, 256), generator=gen, device="cuda").bfloat16()
                   for n in (H, KV, KV))
        dout = torch.randn((B, S, H, 256), generator=gen, device="cuda").bfloat16()
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
        if S == 64:
            assert fa.bwd_split_plan(B, S, KV, H // KV, 256) == H // KV
        b0 = fa.bwd_launches
        got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=window)
        torch.cuda.synchronize()
        assert fa.bwd_launches == b0 + 1
        exp = ref.flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out)), lse,
                                          dout.float(), causal=True, window=window)
        for g, e in zip(got, exp):
            assert g.dtype == torch.bfloat16
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):     # no backward for S != T
        q256 = torch.zeros((1, 16, 2, 256), device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
        kv = torch.zeros((1, 32, 2, 256), device="cuda", dtype=torch.bfloat16)
        ops.flash_attention(q256, kv, kv)


@pytest.mark.gpu
def test_kernels_without_backward_refuse_grad():
    """decode_attention has no backward on the card: a call that needs a
    gradient raises instead of dropping it. rglru_scan (like ssd_scan) has
    one: a call that needs a gradient runs the forward and backward kernels
    and gives the plain version's gradients."""
    _card()
    q = torch.zeros((1, 1, 4, 64), device="cuda", requires_grad=True)
    kc = torch.zeros((1, 32, 4, 64), device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.decode_attention(q, kc, kc, lens)
    with torch.no_grad():                              # without grad it runs
        ops.decode_attention(q, kc, kc, lens)
    a = torch.full((1, 64, 4), -0.1, device="cuda").requires_grad_(True)
    b = torch.ones((1, 64, 4), device="cuda").requires_grad_(True)
    n0, b0 = kernels.rglru_scan.launches, kernels.rglru_scan.bwd_launches
    got = torch.autograd.grad(ops.rglru_scan(a, b)[0].sum(), (a, b))
    assert (kernels.rglru_scan.launches, kernels.rglru_scan.bwd_launches) == (n0 + 1, b0 + 1)
    ac, bc = (t.detach().cpu().requires_grad_(True) for t in (a, b))
    exp = torch.autograd.grad(ref.rglru_scan_ref(ac, bc)[0].sum(), (ac, bc))
    for g, e in zip(got, exp):
        torch.testing.assert_close(g.cpu(), e, **F32_TOL)


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


@pytest.mark.gpu
def test_small_moe_model_serves_on_card_as_on_cpu():
    """A small float32 olmoe-family model (3 MoE layers, head_dim 64,
    attn_chunk 64 < prompt 128, so prefill takes the flash kernel; the
    reference's capacity factor, so tokens are dropped) served on the card
    against the CPU: prefill and 4 decode steps' logits within 1e-4, every
    cache leaf within 1e-4, and exactly one flash launch a layer a prefill and
    one decode launch a layer a step."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    _card()
    cfg = dataclasses.replace(reduced_config("olmoe_1b_7b"), head_dim=64, attn_chunk=64)
    prompt, steps, B = 128, 4, 2
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (B, prompt + steps),
                         generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    out, caches, counts = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model, p = build_model(cfg, device=dev), _to(params, dev)
        kernels.reset_launches()
        with torch.no_grad():
            cache = model.init_cache(B, prompt + steps)
            logits, cache = model.prefill(p, toks[:, :prompt].to(dev), cache)
            out[dev] = [logits.cpu()]
            for i in range(steps):
                pos = torch.full((B,), prompt + i, dtype=torch.int32, device=dev)
                logits, cache = model.decode(p, toks[:, prompt + i:prompt + i + 1].to(dev),
                                             cache, pos)
                out[dev].append(logits.cpu())
        counts[dev], caches[dev] = kernels.launch_counts(), _to(cache, "cpu")
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for name in caches["cpu"]["stack"]["u0"]:
        torch.testing.assert_close(caches["cuda"]["stack"]["u0"][name],
                                   caches["cpu"]["stack"]["u0"][name], atol=1e-4, rtol=1e-4)
    assert counts["cpu"] == {k: 0 for k in kernels.KERNELS}
    assert counts["cuda"] == {k: {"flash_attention": cfg.n_layers,
                                  "decode_attention": cfg.n_layers * steps}.get(k, 0)
                              for k in kernels.KERNELS}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper_small", "paligemma_3b"])
def test_encdec_and_vlm_decode_match_a_fresh_prefill_at_full_width(arch):
    """whisper-small (2 encoder and 2 decoder layers over 1500 frames) and
    paligemma-3b (2 layers, 256 patches) at full width in float32, wq and wk
    at the fan-in of d_model (neither has qk-norm; ``chip_smoke.fan_in_qk``):
    prefill 64 tokens after the frontend stubs, then 8 decode steps on the
    decode kernel (d = 64, G = 1; d = 256, G = 8), against one fresh prefill
    of them all: the last logits within a relative L2 of 3e-2, as
    chip_smoke's check; no launch in prefill, one a layer a decode step."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    _card()
    cs, _ = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    if cfg.encdec:
        cfg = dataclasses.replace(cfg, n_enc_layers=2)
    model = build_model(cfg, device="cuda")
    params = cs.fan_in_qk(cfg, model.init(torch.Generator(device="cuda").manual_seed(0)))
    stubs = cs.stubs_for(torch, cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 72)),
                           dtype=torch.int32, device="cuda")
    kernels.reset_launches()
    with torch.no_grad():
        _, cache = model.prefill(params, toks[:, :64], model.init_cache(1, 320 + 8), **stubs)
    assert kernels.launch_counts() == {k: 0 for k in kernels.KERNELS}
    got = cs.decode_vs_prefill(torch, model, params, toks[:, :64], toks[:, 64:71], stubs)
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 2 * 8 and counts["flash_attention"] == 0, counts
    assert got["rel_l2"] < 3e-2, got


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


@pytest.mark.gpu
def test_pipeline_ranks_one_card_each_over_nccl():
    """chip_smoke.py phase 6's two plans (granite-8b's forward on 3 stages,
    h2o-danube-1.8b's gradients on 4, full width and depth, sequence 4096)
    through ``DistributedPipelineExecutor`` with one nccl rank a card,
    against the in-process executor on cuda:0, at chip_smoke's gates
    (``phase_pipeline_ranks``). It prints each plan's wall time beside the
    one-card in-process executor's and the ratio of that speedup to the
    GPipe ideal S·M/(M + S − 1). With fewer cards than stages it skips."""
    import os
    import subprocess
    import sys

    _card()
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    planned = {w: cs.phase_plan(torch, card, w) for w in cs.PLANS}
    need = max(p["spec"].n_stages for p in planned.values())
    if torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} cards (one rank a stage), saw {torch.cuda.device_count()}")
    out, kept = {}, {"forward": {}, "gradients": {}}
    out["forward"] = cs.phase_pipeline_forward(torch, card, planned["forward"], kept["forward"])
    out["gradients"] = cs.phase_pipeline_grads(torch, card, planned["gradients"],
                                               kept["gradients"])
    ranks = cs.phase_pipeline_ranks(torch, card, planned, out, kept, backend="nccl",
                                    devices=[f"cuda:{i}" for i in range(need)])
    assert ranks["forward"]["bitwise"] or ranks["forward"]["bound_share"] <= 1.0


def _chip_smoke():
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    return cs, card


def _mesh_run(cs, tmp_path, name, *args, **kw):
    pids = tmp_path / f"{name}_pids"
    pids.mkdir()
    return cs.MeshRun(*args, ckpt_dir=str(tmp_path / f"{name}_ckpt"), pid_dir=str(pids), **kw)


@pytest.mark.gpu
def test_mesh_train_world_one_small_on_card(tmp_path):
    """chip_smoke.py phase 8's rank function at a small size: the reduced
    h2o-danube (2 layers, head_dim 80, attn_chunk 64 < S = 256, float32)
    under a (1, 1) mesh on one nccl rank, 2 steps, a sharded checkpoint, the
    elastic controller's remesh onto a fresh group, 1 more step; each step
    against the plain step (``mesh_phase``'s float32 gates), the restore bit
    for bit, the flash kernels launched from the DTensor steps (exact) and
    the DTensor entry's local branch once a flash forward."""
    _card()
    cs, card = _chip_smoke()
    run = _mesh_run(cs, tmp_path, "small", "h2o_danube_1_8b", 2, "float32", 2, 256, 2, 1, 1,
                    reduced=True, overrides=(("head_dim", 80), ("attn_chunk", 64)))
    out = cs.mesh_phase(torch, card, run, 1, ["cuda:0"], "small mesh path")
    assert out["restored_bitwise"] and len(out["rows"]) == 3
    assert out["launches"]["flash_attention"] == 3 * 2 * 2
    assert out["branches"] == {"local": out["launches"]["flash_attention"], "replicate": 0}


@pytest.mark.gpu
def test_gloo_rank_on_card_gets_a_card_mesh():
    """A gloo rank that ``run_ranks`` starts on cuda:0 gets a CUDA mesh from
    ``make_host_mesh()`` (never a CPU one, which would move the card's
    tensors to the host and run the plain attention there), a CPU tensor is
    refused, and the flash forward on a head-sharded DTensor launches the
    kernel on the card."""
    _card()
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_mesh_ranks
    from repro_torch.runtime.ranks import run_ranks

    out, = run_ranks(torch_mesh_ranks.mesh_device_rank, 1, backend="gloo", timeout=120,
                     devices=["cuda:0"])
    assert out["device_type"] == "cuda" and "a cpu tensor on a cuda mesh" in out["refused"]
    assert out["launches"] == 1 and out["out_device"] == "cuda"


@pytest.mark.gpu
def test_elastic_tensor_parallel_four_cards_to_two(tmp_path):
    """h2o-danube-1.8b at full width and depth (24 layers, bf16, batch 2 x
    8192, remat="full", wq/wk at the fan-in of d_model) tensor-parallel on a
    (1, 4) mesh, one nccl rank a card: 3 steps, a sharded checkpoint, then
    ranks 2 and 3 fall silent and exit, the elastic controller regroups
    ranks 0 and 1 into (1, 2), restores (bit for bit) and trains 2 more
    steps. Every step is held against the one-card plain step from the same
    state on cuda:0 (``mesh_phase``: the bf16 bound phase 6 holds its loss
    to, and phase 6's rule for the clipped gradients against the float32
    model's: the DTensor step's worst leaf at most 1.5 x the plain step's
    share of the backward's bound); then in float32 at 4 layers and batch 1 x 4096, the loss and grad
    norm within 1e-4 relative, the first moments after each step within
    1e-4 of each leaf's max and the parameters within the float32 tolerance
    (2e-5 + 2e-5 |ref|). Every rank attends its own
    heads (H 32 and KV 8 divide 4 and 2: the DTensor entry's local branch).
    With fewer than 4 cards it skips."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards (one rank a card), saw {torch.cuda.device_count()}")
    cs, card = _chip_smoke()
    devices = [f"cuda:{i}" for i in range(4)]
    bf16 = cs.mesh_phase(torch, card, _mesh_run(cs, tmp_path, "bf16", "h2o_danube_1_8b", None,
                                                "bfloat16", 2, 8192, 3, 2, 2),
                         4, devices, "h2o tp 4 -> 2 (bf16)", timeout=480)
    f32 = cs.mesh_phase(torch, card, _mesh_run(cs, tmp_path, "f32", "h2o_danube_1_8b", 4,
                                               "float32", 1, 4096, 1, 2, 1),
                        4, devices, "h2o tp 4 -> 2 (float32)", timeout=300)
    for out, steps in ((bf16, 5), (f32, 2)):
        assert out["restored_bitwise"] and len(out["rows"]) == steps
        assert out["branches"] == {"local": out["launches"]["flash_attention"], "replicate": 0}
        assert sorted(out["step_ms_by_mesh"]) == ["(1, 2)", "(1, 4)"]


@pytest.mark.gpu
def test_flash_attention_bwd_at_olmoe_training_shape():
    """The bf16 flash backward at olmoe-1b-7b's training shape (B = 2, S =
    4096, 16 query heads on 16 KV heads: G = 1, d = 128, causal), one launch,
    against its plain version a (batch row, head) at a time (chip_smoke's
    ``flash_bwd_plain``) within the bf16 bound with the backward's floor."""
    gen = _card()
    cs, _ = _chip_smoke()
    B, S, H, d = cs.OLMOE_TRAIN_BATCH, cs.OLMOE_TRAIN_SEQ, cs.OLMOE_HEADS, cs.HEAD_DIM
    q, k, v, dout = (torch.randn((B, S, H, d), generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    b0 = kernels.flash_attention.bwd_launches
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    torch.cuda.synchronize()
    assert kernels.flash_attention.bwd_launches == b0 + 1
    exp = cs.flash_bwd_plain(torch, ref, q, k, v, out, lse, dout, None)
    for g, e in zip(got, exp):
        assert g.dtype == torch.bfloat16
        _assert_within_bf16_bound(g, e, BWD_FLOOR)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_moe_train_step_card_matches_cpu(arch):
    """chip_smoke.py phase 4's float32 MoE train steps: the reduced olmoe
    (head_dim 64, attn_chunk 64 < S = 256: the flash forward and backward at
    G = 1, launches exact) and the reduced deepseek (MLA's query chunks under
    the units' remat, no launch), each on the card against the CPU: the
    loss, the aux loss and grad_norm within 1e-4 relative, every gradient
    within 1e-4 of its leaf's max."""
    _card()
    cs, card = _chip_smoke()
    spec, = [s for s in cs.SMALL_TRAIN if s[0] == arch]
    out = cs.phase_small_train(torch, card, *spec)
    assert max(out["loss_rel_err"], out["grad_rel_err"], *out["step_rel_err"].values()) <= 1e-4
    assert out["launches"]["flash_attention"] == (6 if arch == "olmoe_1b_7b" else 0)


@pytest.mark.gpu
def test_elastic_example_on_four_cards():
    """``examples/elastic_recovery_torch.py --ranks 4`` on four cards, one
    nccl rank a card: 4 steps, a sharded checkpoint, ranks 2 and 3 fail, the
    survivors regroup into a (1, 2) mesh, restore step 4 and take a finite
    step. With fewer than 4 cards it skips (the example itself exits
    non-zero there)."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards (one rank a card), saw {torch.cuda.device_count()}")
    import importlib
    import math
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                    "examples"))
    out = importlib.import_module("elastic_recovery_torch").main(["--ranks", "4"])
    assert out["failed"] == [2, 3] and out["world"] == 2 and out["step"] == 4
    assert all(math.isfinite(x) for x in out["losses"] + [out["resumed_loss"]])


@pytest.mark.gpu
def test_quantize_int8_on_card_matches_cpu_bitwise():
    """``quantize_int8`` and ``ef_compress`` on the card against the same
    calls on CPU copies, bit for bit, over 2000 tensors of random absmax (a
    scale computed as absmax times the float32 reciprocal of 127, as a CUDA
    tensor divided by a Python number is, differs from the quotient by an
    ulp for ~5% of them)."""
    from repro_torch.optim import ef_compress, quantize_int8

    gen = _card()
    for i in range(2000):
        x = torch.randn((33,), generator=gen, device="cuda") * float(1.5 ** (i % 40 - 20))
        q, s = quantize_int8(x)
        q_c, s_c = quantize_int8(x.cpu())
        assert float(s) == float(s_c) and torch.equal(q.cpu(), q_c), i
    g = {"w": torch.randn((64, 64), generator=gen, device="cuda").to(torch.bfloat16)}
    e = {"w": torch.randn((64, 64), generator=gen, device="cuda") * 1e-3}
    d, r, _ = ef_compress(g, e)
    d_c, r_c, _ = ef_compress({"w": g["w"].cpu()}, {"w": e["w"].cpu()})
    assert torch.equal(d["w"].cpu(), d_c["w"]) and torch.equal(r["w"].cpu(), r_c["w"])


@pytest.mark.gpu
def test_mesh_archs_one_card_small():
    """chip_smoke.py phase 8's arch runs at a small size on one nccl rank's
    (1, 1) mesh: the reduced olmoe (head_dim 64, attn_chunk 64 < S = 256:
    the flash kernels at G = 1, launches exact), deepseek's loss and
    gradients (MLA, a shared expert), whisper and paligemma, bf16; the loss
    bitwise and the grad norms within ``MESH_ONE_GNORM_TOL`` of the plain
    step's, the DTensor entry's local branch only (``arch_mesh_gate``)."""
    _card()
    from repro_torch.runtime.ranks import run_ranks

    cs, card = _chip_smoke()
    R = cs.ArchMeshRun
    runs = [R("olmoe_1b_7b", 2, "bfloat16", 2, 256, 2, reduced=True,
              overrides=(("head_dim", 64), ("attn_chunk", 64))),
            R("deepseek_v2_236b", 2, "bfloat16", 1, 256, 1, adamw=False, reduced=True,
              overrides=(("attn_chunk", 64),)),
            R("whisper_small", 2, "bfloat16", 4, 32, 1, qk_fan_in=True, reduced=True),
            R("paligemma_3b", 2, "bfloat16", 2, 32, 1, qk_fan_in=True, reduced=True)]
    recs = run_ranks(cs.arch_mesh_rank, 1, (runs,), backend="nccl", timeout=300,
                     devices=["cuda:0"])
    out = cs.arch_mesh_gate(torch, card, recs, "small mesh")
    assert [len(s["rows"]) for s in out] == [2, 1, 1, 1]
    assert all(r["bitwise"] for s in out for r in s["rows"])
    assert out[0]["launches"]["flash_attention"] == 2 * 4
    assert out[0]["branches"] == {"local": 2 * 4, "replicate": 0}


def _four_cards():
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 cards (one rank a card), saw {torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(4)]


@pytest.fixture(scope="module")
def four_card_archs():
    """The four-card runs, one process a card for all of them, and one card's
    plain steps in a process of its own (``chip_smoke.arch_mesh_rank``):
    olmoe_1b_7b at full width and depth (16 layers, 64 experts, 16 a rank),
    deepseek_v2_236b at 4 of 60 layers with AdamW, whisper_small (12 + 12
    layers) and paligemma_3b (18 layers) on a (1, 4) mesh, bf16, remat
    "full"; beside them one card's plain step of olmoe at 8 layers and of
    whisper and paligemma at full depth. Each gated by ``arch_mesh_gate``
    (finite, launches exact, E / 4 expert rows a rank)."""
    devices = _four_cards()
    from repro_torch.runtime.ranks import run_ranks

    cs, card = _chip_smoke()
    R = cs.ArchMeshRun
    mesh_runs = [R("olmoe_1b_7b", None, "bfloat16", 2, 4096, 10, mesh=(1, 4), compare=False),
                 R("deepseek_v2_236b", 4, "bfloat16", 1, 4096, 6, mesh=(1, 4), compare=False),
                 R("whisper_small", None, "bfloat16", 8, 448, 10, mesh=(1, 4), compare=False,
                   qk_fan_in=True),
                 R("paligemma_3b", None, "bfloat16", 2, 512, 10, mesh=(1, 4), compare=False,
                   qk_fan_in=True)]
    one_runs = [R("olmoe_1b_7b", 8, "bfloat16", 2, 4096, 10, mesh=None, compare=False),
                R("whisper_small", None, "bfloat16", 8, 448, 10, mesh=None, compare=False,
                  qk_fan_in=True),
                R("paligemma_3b", None, "bfloat16", 2, 512, 10, mesh=None, compare=False,
                  qk_fan_in=True)]
    out = {}
    # deepseek in a group of its own: the largest state, so a failure there
    # leaves the other runs' results standing (each test raises its own group's)
    for name, runs, world, timeout in (("four", mesh_runs[:1] + mesh_runs[2:], 4, 420),
                                       ("deepseek", mesh_runs[1:2], 4, 300),
                                       ("one", one_runs, 1, 300)):
        try:
            recs = run_ranks(cs.arch_mesh_rank, world, (runs,), backend="nccl", timeout=timeout,
                             devices=devices[:world])
            out[name] = {s["config"]: s for s in cs.arch_mesh_gate(
                torch, card, recs, "four cards" if world == 4 else "one card")}
        except Exception as e:          # re-raised by the tests that read this group
            out[name] = e
    return out


def _group(runs, name):
    if isinstance(runs[name], Exception):
        raise runs[name]
    return runs[name]


@pytest.mark.gpu
def test_olmoe_full_depth_trains_on_four_cards(four_card_archs):
    """olmoe_1b_7b at all 16 layers, B = 2 x 4096, on a (1, 4) mesh: 16 of
    its 64 experts on every rank, the flash launches exact, the loss falls
    over 10 steps; one card's 8-layer step timed beside it."""
    four, one = _group(four_card_archs, "four"), _group(four_card_archs, "one")
    run = four["olmoe-1b-7b"]
    assert run["n_layers"] == 16 and set(run["expert_rows"].values()) == {16}
    assert run["losses"][-1] < run["losses"][0]
    assert one["olmoe-1b-7b"]["n_layers"] == 8 and one["olmoe-1b-7b"]["ms_median"] > 0


@pytest.mark.gpu
def test_deepseek_adamw_step_on_four_cards(four_card_archs):
    """deepseek_v2_236b's whole train step, AdamW included, at 4 of 60
    layers (the dense-first layer and three MoE units, 40 of 160 experts a
    rank), B = 1 x 4096, on a (1, 4) mesh: finite, the loss falling over 6
    steps."""
    run = _group(four_card_archs, "deepseek")["deepseek-v2-236b"]
    assert run["n_layers"] == 4 and set(run["expert_rows"].values()) == {40}
    assert run["losses"][-1] < run["losses"][0]


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["whisper-small", "paligemma-3b"])
def test_encdec_and_vlm_full_depth_on_four_cards(four_card_archs, config):
    """whisper_small (12 + 12 layers, B = 8 x 448) and paligemma_3b (18
    layers, B = 2 x (256 + 512)) at full depth on a (1, 4) mesh, the loss
    falling over 10 steps, one card's full-depth plain step beside each."""
    four, one = _group(four_card_archs, "four"), _group(four_card_archs, "one")
    assert four[config]["n_layers"] == one[config]["n_layers"]
    assert four[config]["losses"][-1] < four[config]["losses"][0]


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_mesh_archs_float32_parity_on_four_cards(mesh):
    """The four archs at small float32 configs (the reduced widths at 2
    layers; olmoe at head_dim 64 and attn_chunk 64 < S = 256, so the flash
    kernels run on each rank's heads; deepseek at attn_chunk 64: MLA's query
    chunks), 2 AdamW steps on a (1, 4) and a (2, 2) mesh, each held against
    the one-card plain step from the same state on cuda:0: loss and grad
    norm within ``MESH_ONE_GNORM_TOL`` relative, the first moments within
    1e-4 of each leaf's max, the parameters within the float32 tolerance."""
    devices = _four_cards()
    from repro_torch.runtime.ranks import run_ranks

    cs, card = _chip_smoke()
    R = cs.ArchMeshRun
    runs = [R("olmoe_1b_7b", 2, "float32", 4, 256, 2, mesh=mesh, reduced=True,
              overrides=(("head_dim", 64), ("attn_chunk", 64))),
            R("deepseek_v2_236b", 2, "float32", 4, 256, 2, mesh=mesh, reduced=True,
              overrides=(("attn_chunk", 64),)),
            R("whisper_small", 2, "float32", 4, 32, 2, mesh=mesh, qk_fan_in=True, reduced=True),
            R("paligemma_3b", 2, "float32", 4, 32, 2, mesh=mesh, qk_fan_in=True, reduced=True)]
    out = cs.arch_mesh_gate(torch, card, run_ranks(cs.arch_mesh_rank, 4, (runs,),
                                                   backend="nccl", timeout=300,
                                                   devices=devices), f"f32 parity {mesh}")
    assert [len(s["rows"]) for s in out] == [2, 2, 2, 2]
    assert out[0]["launches"]["flash_attention"] == 2 * 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_partial_matches_plain_and_merges(dtype):
    """The sharded-keys mode at chip_smoke.py phase 2's shapes: qwen3-32b's
    (B 4, T 4128 in 4 shards of 1032) and h2o-danube-1.8b's d = 80 with its
    4096 window (T 8256 in 4 shards of 2064; a length past shard 0's end
    with its window's start inside it), lengths that leave shards empty:
    each shard's o (bf16 bound, or float32 tolerance) and lse (float32
    tolerance) against ``decode_attention_partial_ref``, one launch each;
    the four shards merged by log-sum-exp against the one-card kernel."""
    from repro_torch.kernels import decode_attention as dec
    gen = _card()
    cs, _ = _chip_smoke()
    for (B, T, H, KV, d), lens, window in [((4, 4128, 64, 8, 128), [4128, 3000, 1100, 17], None),
                                           ((4, 8256, 32, 8, 80), [8256, 5000, 2100, 1], 4096)]:
        q = torch.randn((B, 1, H, d), generator=gen, device="cuda").to(dtype)
        kc = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        vc = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n = T // 4
        parts = []
        for a in range(0, T, n):
            ks, vs = kc[:, a:a + n].contiguous(), vc[:, a:a + n].contiguous()
            n0 = kernels.decode_attention.launches
            o, lse = dec.decode_attention_partial(q, ks, vs, cl, kv_offset=a, window=window)
            torch.cuda.synchronize()
            assert kernels.decode_attention.launches == n0 + 1
            assert o.dtype == lse.dtype == torch.float32 and lse.shape == (B, H)
            exp_o, exp_lse = dec.decode_attention_partial_ref(
                q.float(), ks.float(), vs.float(), cl, kv_offset=a, window=window)
            if dtype == torch.float32:
                torch.testing.assert_close(o, exp_o, **F32_TOL)
            else:
                _assert_within_bf16_bound(o, exp_o)
            torch.testing.assert_close(lse, exp_lse, **F32_TOL)
            parts.append((o, lse))
        merged = cs.merge_on_one_card(torch, parts)
        one = ops.decode_attention(q, kc, vc, cl, window=window)
        if dtype == torch.float32:
            torch.testing.assert_close(merged, one, **F32_TOL)
        else:
            _assert_within_bf16_bound(merged, one.float())


def _reduced_serve_runs(cs, dtype, mesh=(1, 1)):
    """Every arch's reduced config at 2 layers (recurrentgemma 3: one
    (rec, rec, local_attn) unit), head_dim 64 where the reduced one has none
    the decode kernel takes, batch 4, prompt 16 (h2o 40, past its 32-token
    window), 4 steps, with the launches each makes."""
    R = cs.ServeMeshRun
    hd = (("head_dim", 64),)
    return [R("qwen3_32b", 2, dtype, 4, 16, 4, {}, {"decode_attention": 2}, mesh=mesh,
              reduced=True),
            R("h2o_danube_1_8b", 2, dtype, 4, 40, 4, {}, {"decode_attention": 2}, mesh=mesh,
              reduced=True, qk_fan_in=True),
            R("mamba2_780m", 2, dtype, 4, 16, 4, {"ssd_scan": 2}, {}, mesh=mesh, reduced=True),
            R("recurrentgemma_9b", 3, dtype, 4, 16, 4, {"rglru_scan": 2}, {"decode_attention": 1},
              mesh=mesh, reduced=True, overrides=hd, qk_fan_in=True),
            R("olmoe_1b_7b", 2, dtype, 4, 16, 4, {}, {"decode_attention": 2}, mesh=mesh,
              reduced=True),
            R("deepseek_v2_236b", 2, dtype, 4, 16, 4, {}, {}, mesh=mesh, reduced=True),
            R("whisper_small", 2, dtype, 4, 16, 4, {}, {"decode_attention": 4}, mesh=mesh,
              reduced=True, overrides=hd, qk_fan_in=True),
            R("paligemma_3b", 2, dtype, 4, 16, 4, {}, {"decode_attention": 2}, mesh=mesh,
              reduced=True, overrides=hd, qk_fan_in=True)]


@pytest.mark.gpu
def test_serving_mesh_one_card_small():
    """chip_smoke.py phase 8's serving runs at a small size, float32, on one
    nccl rank's (1, 1) mesh: every arch's greedy tokens equal to the plain
    serve's in the same rank, the logits within 1e-5 relative L2, the
    launches exact, every decode attention on the sharded-keys branch."""
    _card()
    from repro_torch.runtime.ranks import run_ranks

    cs, card = _chip_smoke()
    runs = _reduced_serve_runs(cs, "float32")
    recs = run_ranks(cs.serve_mesh_rank, 1, (runs,), backend="nccl", timeout=300,
                     devices=["cuda:0"])
    out = cs.serve_mesh_gate(torch, card, recs, "small serving mesh", 1e-5)
    assert len(out) == len(runs) and all(s["logits_rel_l2"] <= 1e-5 for s in out)


@pytest.fixture(scope="module")
def four_card_serve():
    """qwen3_32b at full width and all 64 layers on a (1, 4) nccl mesh, one
    rank a card: batch 4, a 32256-token prompt (through the flash kernel on
    each rank's 16 heads), 32 greedy steps into a 32768-slot cache sharded
    over "model" (8192 slots a rank, each holding live keys), then a fresh
    prefill of the prompt and the 32 fed tokens on the same mesh; beside it
    the same 8 layers on the mesh and on one card alone; deepseek_v2_236b at
    4 of 60 layers in float32 at the lossless capacity (its MLA latents
    sharded over "model"), batch 4 x 512, 16 steps, with the same check.
    Each group's exception is kept for the tests that read it."""
    devices = _four_cards()
    from repro_torch.runtime.ranks import run_ranks

    cs, card = _chip_smoke()
    L = cs.ServeLongRun
    from repro_torch.configs import get_config
    ds_cfg = get_config("deepseek_v2_236b")
    lossless = (("capacity_factor", ds_cfg.n_experts / ds_cfg.experts_per_token),)
    groups = {"qwen3": (L("qwen3_32b", None, "bfloat16", 4, 32256, 32, 32768), 4, 900),
              "qwen3 8 layers": (L("qwen3_32b", 8, "bfloat16", 4, 32256, 32, 32768,
                                   check=False), 4, 600),
              "qwen3 8 layers one card": (L("qwen3_32b", 8, "bfloat16", 4, 32256, 32, 32768,
                                            mesh=None, check=False), 1, 600),
              "deepseek": (L("deepseek_v2_236b", 4, "float32", 4, 512, 16, 528,
                             overrides=lossless), 4, 600)}
    out = {}
    for name, (run, world, timeout) in groups.items():
        try:
            out[name] = run_ranks(cs.serve_long_rank, world, (run,), backend="nccl",
                                  timeout=timeout, devices=devices[:world])
        except Exception as e:          # re-raised by the tests that read this group
            out[name] = e
    return cs, card, out


def _long(runs, name):
    cs, card, out = runs
    if isinstance(out[name], Exception):
        raise out[name]
    return cs, card, out[name]


def _log_long(cs, card, name, recs):
    r0 = recs[0]
    lat = r0["decode_ms"][1:]
    p50 = float(sorted(lat)[len(lat) // 2])
    p99 = float(sorted(lat)[min(len(lat) - 1, int(0.99 * len(lat)))])
    cs.log(card, f"{name}: {r0['config']} {r0['n_layers']} of {r0['full_layers']} layers "
                 f"{r0['dtype']} on {r0['mesh']}, batch {r0['batch']} x {r0['prompt']} + "
                 f"{r0['gen']} steps into {r0['max_len']} slots: prefill {r0['prefill_ms']:.1f} "
                 f"ms, decode p50 {p50:.2f} ms p99 {p99:.2f} ms (host clock, synchronised); "
                 f"peak GiB a rank {[round(r['peak_bytes'] / 2**30, 2) for r in recs]}, cache "
                 f"GiB a rank {[round(r['cache_bytes'] / 2**30, 3) for r in recs]}, parameter "
                 f"GiB a rank {[round(r['param_bytes'] / 2**30, 2) for r in recs]}; launches "
                 f"{ {k: v for k, v in r0['launches'].items() if v} }; check "
                 f"{r0.get('check')}; decode profile "
                 f"{ {k: r0['profile'][k] for k in ('wall_ms', 'busy_ms', 'decode kernel', 'collectives')} }")
    return p50, p99


@pytest.mark.gpu
def test_qwen3_full_depth_serves_a_32k_cache_on_four_cards(four_card_serve):
    """All 64 layers: the flash kernel once a layer at prefill and the decode
    kernel's sharded-keys mode once a layer a step, every rank's shard 8192
    slots, and the last step's logits within phase 3's bf16 bound of the fresh
    prefill's."""
    cs, card, recs = _long(four_card_serve, "qwen3")
    _log_long(cs, card, "four cards", recs)
    for r in recs:
        assert r["n_layers"] == 64
        assert r["launches"]["flash_attention"] == 64
        assert r["launches"]["decode_attention"] == 64 * 32
        assert r["cache_bytes"] == 64 * 2 * 4 * 8192 * 8 * 128 * 2      # k and v, 8192 slots
    check = recs[0]["check"]
    assert check["finite"] and check["rel_l2"] <= cs.DECODE_PREFILL_TOL, check


@pytest.mark.gpu
def test_qwen3_eight_layers_on_four_cards_and_one(four_card_serve):
    """The same cache at 8 layers on the (1, 4) mesh and on one card alone:
    both serve, and their times are logged side by side."""
    cs, card, mesh = _long(four_card_serve, "qwen3 8 layers")
    _, _, one = _long(four_card_serve, "qwen3 8 layers one card")
    _log_long(cs, card, "four cards", mesh)
    _log_long(cs, card, "one card", one)
    assert one[0]["launches"]["decode_attention"] == mesh[0]["launches"]["decode_attention"] \
        == 8 * 32
    assert one[0]["cache_bytes"] == 4 * mesh[0]["cache_bytes"]


@pytest.mark.gpu
def test_deepseek_mla_cache_sharded_on_four_cards(four_card_serve):
    """deepseek_v2_236b at 4 of 60 layers in float32 at the lossless
    capacity: its MLA latents sharded over "model", the last step's logits
    within phase 3's bound of a fresh prefill's."""
    cs, card, recs = _long(four_card_serve, "deepseek")
    _log_long(cs, card, "four cards", recs)
    check = recs[0]["check"]
    assert check["finite"] and check["rel_l2"] <= cs.DECODE_PREFILL_TOL, check
    assert all(r["cache_bytes"] == 4 * 4 * 132 * (512 + 64) * 4 for r in recs)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_serving_mesh_float32_parity_on_four_cards(mesh):
    """Every arch's small float32 config served on a (1, 4) and a (2, 2)
    mesh of four cards against the plain serve in each rank: the greedy
    tokens equal, the logits within 1e-5 relative L2, the launches exact,
    every decode attention merged across the ranks (``serve_mesh_gate``)."""
    devices = _four_cards()
    from repro_torch.runtime.ranks import run_ranks

    cs, card = _chip_smoke()
    runs = _reduced_serve_runs(cs, "float32", mesh=mesh)
    out = cs.serve_mesh_gate(torch, card, run_ranks(cs.serve_mesh_rank, 4, (runs,),
                                                    backend="nccl", timeout=300,
                                                    devices=devices), f"f32 serving {mesh}", 1e-5)
    assert len(out) == len(runs)


# -- the dry-run's shape-only path on the card machine ---------------------------------
@pytest.mark.gpu
def test_dryrun_flops_besides_the_kernels_equal_a_card_step():
    """h2o_danube_1_8b at 2 layers, 1 x 4096 (chip_smoke phase 10's check):
    the dry-run on a fake one-rank mesh of fake "cuda" tensors, and the real
    train step on the card under FlopCounterMode, which cannot see the
    card's kernels: its count equals the dry-run's FLOPs besides the
    kernels exactly."""
    _card()
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("h2o_danube_1_8b"), n_layers=2)
    shape = ShapeSpec("train_4k_batch_1", 4096, 1, "train")
    dry = dryrun.run_one_rank(cfg, shape, device="cuda")
    assert set(dry["kernel_flops"]) == {"flash_attention", "flash_attention_bwd"}
    model, step = make_train_step(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    toks = torch.randint(0, cfg.vocab_size, (1, 4097), device="cuda", dtype=torch.int32)
    kernels.reset_launches()
    with FlopCounterMode(display=False) as counter:
        step(params, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 2
    assert counter.get_total_flops() == \
        dry["per_device_flops"] - sum(dry["kernel_flops"].values())


@pytest.mark.gpu
def test_shape_only_path_on_fake_card_tensors():
    """Fake "cuda" tensors take the shape-only path with the card's checks:
    no launch, the kernel's shapes, a head_dim the kernels lack refused; the
    Python copy of the flash backward's scratch size equals the C entry's."""
    _card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa

    kernels.reset_launches()
    with FakeTensorMode():
        q, k, v = (torch.empty(2, 256, n, 80, dtype=torch.bfloat16, device="cuda")
                   for n in (8, 2, 2))
        out, lse = fa.flash_attention_fwd(q, k, v)
        assert out.shape == q.shape and lse.shape == (2, 8, 256) and out.is_cuda
        bad = torch.empty(2, 256, 8, 32, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(bad, bad[:, :, :2], bad[:, :, :2])
    assert all(n == 0 for n in kernels.launch_counts().values())
    lib = fa._bwd_lib()
    for B, S, H, KV, d, dt, n in ((2, 4096, 64, 8, 128, torch.bfloat16, 1),
                                  (1, 100, 48, 1, 80, torch.bfloat16, 4),
                                  (2, 333, 8, 2, 64, torch.float32, 1)):
        code = 1 if dt == torch.bfloat16 else 0
        assert fa.bwd_scratch_floats(B, S, H, KV, d, dt, n) == \
            lib.flash_attention_bwd_scratch_floats(B, S, H, KV, d, code, n)
