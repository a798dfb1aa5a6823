"""Hand-written Hopper (sm_90a) kernels for the serving hot spots, each in
its own module with its plain PyTorch version and a launch counter:

* ``flash_attention``  — causal/SWA/GQA flash attention (prefill)
* ``decode_attention`` — one token against the KV cache (decode)

The public entry points are in ``ops``; the submodule names stay free for
the modules, so ``kernels.flash_attention.launches`` is the counter. The
Mamba-2 and RG-LRU scans are not ported yet (see ROADMAP.md).
"""
from . import decode_attention, flash_attention

KERNELS = {"flash_attention": flash_attention, "decode_attention": decode_attention}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


__all__ = ["KERNELS", "reset_launches", "launch_counts"]
