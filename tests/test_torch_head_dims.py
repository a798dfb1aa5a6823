"""The head dims the card's attention kernels take, against the configs.

Every head_dim of every registered config, full (``get_config``) or reduced
(``reduced_config``), must be one that the flash forward, the flash
backward and the decode kernel take on the card in both float32 and
bfloat16: a config whose attention the card refuses cannot be served or
trained there. The lists are checked two ways: as data, against the
configs, and through the wrappers' own card checks, which run on fake
CUDA tensors (``FakeTensorMode``) here on the CPU: a listed head_dim passes
them and takes the shape-only path (``kernels/shape_only.py``), giving
outputs of the card's shapes; an unlisted one still raises.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa

DTYPES = (torch.float32, torch.bfloat16)
# head dims the reduced configs brought to the card (16: the reduced dense and
# MoE configs; 24: whisper_small; 32: recurrentgemma_9b and paligemma_3b), and
# float32 256 (the full recurrentgemma_9b's and paligemma_3b's) for flash
NEW = [(d, dt) for d in (16, 24, 32) for dt in DTYPES] + [(256, torch.float32)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registered_head_dim_is_a_card_head_dim(arch):
    """The config's head_dim, full and reduced, is in flash's ``HEAD_DIMS``
    and ``BWD_HEAD_DIMS`` and decode's ``HEAD_DIMS`` for both types; a
    config without one (the SSM; MLA, which runs as einsums) has no
    attention kernel to take it."""
    for cfg in (get_config(arch), reduced_config(arch)):
        d = cfg.head_dim
        if d is None:
            assert cfg.family == "ssm" or cfg.mla, cfg.name
            continue
        assert d in dec.HEAD_DIMS, (cfg.name, d)
        for dt in DTYPES:
            assert d in fa.HEAD_DIMS[dt], (cfg.name, d, dt)
            assert d in fa.BWD_HEAD_DIMS[dt], (cfg.name, d, dt)


def test_the_three_lists_name_the_same_head_dims():
    """Forward, backward and decode take one set in both types, so nothing
    that prefills on the card fails to train or decode there."""
    for dt in DTYPES:
        assert fa.HEAD_DIMS[dt] == fa.BWD_HEAD_DIMS[dt] == dec.HEAD_DIMS
    assert dec.HEAD_DIMS == (16, 24, 32, 64, 80, 128, 256)


def _card(shape, dtype):
    """A fake CUDA tensor (made under the caller's ``FakeTensorMode``; this
    build of torch cannot view one, so each operand is made whole)."""
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("d,dtype", NEW)
def test_flash_forward_and_backward_take_the_head_dim_on_fake_card_tensors(d, dtype):
    """``flash_attention`` (the serving call), and ``flash_attention_fwd``
    with ``flash_attention_bwd`` (what ``FlashAttentionFn`` runs for a
    gradient) pass the card's checks and return the card's shapes: causal
    GQA with a window, and non-causal S != T for the forward."""
    B, S, H, KV = 2, 96, 4, 2
    with FakeTensorMode():
        q, k, v = _card((B, S, H, d), dtype), _card((B, S, KV, d), dtype), \
            _card((B, S, KV, d), dtype)
        out = fa.flash_attention(q, k, v, causal=True, window=32)
        assert out.shape == (B, S, H, d) and out.dtype == dtype and out.is_cuda
        kt = _card((B, 160, KV, d), dtype)
        assert fa.flash_attention(q, kt, kt, causal=False).shape == (B, S, H, d)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=32)
        assert out.shape == (B, S, H, d) and tuple(lse.shape) == (B, H, S)
        assert lse.dtype == torch.float32
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, out, causal=True, window=32)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        assert dq.dtype == dk.dtype == dv.dtype == dtype


@pytest.mark.parametrize("d,dtype", [c for c in NEW if c[0] != 256])
def test_decode_takes_the_head_dim_on_fake_card_tensors(d, dtype):
    """``decode_attention`` and its sharded-keys mode
    ``decode_attention_partial`` pass the card's checks and return the
    card's shapes: (B,1,H,d) in q's type; o (B,1,H,d) float32 and lse (B,H)."""
    B, T, H, KV = 3, 64, 8, 2
    with FakeTensorMode():
        q = _card((B, 1, H, d), dtype)
        kc, vc = _card((B, T, KV, d), dtype), _card((B, T, KV, d), dtype)
        lens = _card((B,), torch.int32)
        out = dec.decode_attention(q, kc, vc, lens, window=16)
        assert out.shape == (B, 1, H, d) and out.dtype == dtype and out.is_cuda
        ks, vs = _card((B, T // 2, KV, d), dtype), _card((B, T // 2, KV, d), dtype)
        o, lse = dec.decode_attention_partial(q, ks, vs, lens, kv_offset=T // 2)
        assert o.shape == (B, 1, H, d) and o.dtype == torch.float32
        assert tuple(lse.shape) == (B, H) and lse.dtype == torch.float32


@pytest.mark.parametrize("d", [8, 40, 48, 96])
@pytest.mark.parametrize("dtype", DTYPES)
def test_an_unlisted_head_dim_still_raises_on_fake_card_tensors(d, dtype):
    """No fallback: a card tensor at a head_dim outside the lists raises in
    every entry, as a real one does."""
    with FakeTensorMode():
        q = _card((1, 16, 4, d), dtype)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(q, q, q)
        lse = _card((1, 4, 16), torch.float32)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_bwd(q, q, q, q, lse, q)
        q1, lens = _card((1, 1, 4, d), dtype), _card((1,), torch.int32)
        with pytest.raises(ValueError, match="head_dim"):
            dec.decode_attention(q1, q, q, lens)
        with pytest.raises(ValueError, match="head_dim"):
            dec.decode_attention_partial(q1, q, q, lens, kv_offset=0)
