"""Hand-written Hopper (sm_90a) kernels for the serving hot spots, each in
its own module with its plain PyTorch version and a launch counter:

* ``flash_attention``  — causal/SWA/GQA flash attention (prefill)
* ``decode_attention`` — one token against the KV cache (decode)
* ``ssd_scan``         — Mamba-2 SSD chunked scan (mamba2 prefill)
* ``rglru_scan``       — RG-LRU linear recurrence (recurrentgemma prefill)

The public entry points are in ``ops``; the submodule names stay free for
the modules, so ``kernels.flash_attention.launches`` is the counter.
"""
from . import decode_attention, flash_attention, rglru_scan, ssd_scan

KERNELS = {"flash_attention": flash_attention, "decode_attention": decode_attention,
           "ssd_scan": ssd_scan, "rglru_scan": rglru_scan}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


__all__ = ["KERNELS", "reset_launches", "launch_counts"]
