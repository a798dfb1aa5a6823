"""The port's CUDA kernels on the card (marker ``gpu``; they skip without a
CUDA device). This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version: float32 on the
same inputs at atol/rtol 2e-5 (TF32 off); bfloat16 against the plain
version run in float32 on the same values, elementwise within
2**-5 * (|ref| + rms of ref's row over head_dim), which covers the
kernels' own roundings (P to bf16 in flash, the output to bf16) several
times over and stays well below the size of a late output row.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ops, ref

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_RTOL = 2.0 ** -5


def _assert_matches_plain(out, plain, *tensors):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, plain(*tensors), **F32_TOL)
        return
    exp = plain(*(t.float() for t in tensors))
    err = (out.float() - exp).abs()
    bound = BF16_RTOL * (exp.abs() + exp.pow(2).mean(dim=-1, keepdim=True).sqrt())
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
            ((1, 130, 130, 16, 4, 64), True, 40)]:
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(dtype):
    gen = _card()
    for (B, T, H, KV, d), lens, window in [
            ((4, 256, 4, 4, 64), [1, 17, 100, 256], None),
            ((3, 300, 8, 1, 128), [101, 300, 7], 96),
            ((2, 4128, 64, 8, 128), [4128, 3000], None),
            ((1, 64, 48, 1, 128), [0], None)]:          # no live key: zeros
        q = torch.randn((B, 1, H, d), generator=gen, device="cuda").to(dtype)
        kc = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        vc = torch.randn((B, T, KV, d), generator=gen, device="cuda").to(dtype)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n0 = kernels.decode_attention.launches
        out = ops.decode_attention(q, kc, vc, cl, window=window)
        torch.cuda.synchronize()
        assert kernels.decode_attention.launches == n0 + 1
        if lens == [0]:
            assert not out.any()
            continue
        _assert_matches_plain(out, lambda q, kc, vc: ref.decode_attention_ref(
            q, kc, vc, cl, window=window), q, kc, vc)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    _card()
    q = torch.zeros((1, 16, 4, 80), device="cuda")             # head_dim 80
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q[..., :64].half(), q[..., :64].half(), q[..., :64].half())
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q[:, :1], q, q, torch.ones(1, dtype=torch.int32, device="cuda"))
