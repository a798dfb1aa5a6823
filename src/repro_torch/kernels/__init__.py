"""Hand-written Hopper (sm_90a) kernels for the hot spots, each in its own
module with its plain PyTorch version and a launch counter:

* ``flash_attention``  — causal/SWA/GQA flash attention (prefill, training)
* ``flash_attention_bwd`` — its gradient (training; in the same module)
* ``decode_attention`` — one token against the KV cache (decode)
* ``ssd_scan``         — Mamba-2 SSD chunked scan (mamba2 prefill, training)
* ``ssd_scan_bwd``     — its gradient (training; in the same module)
* ``rglru_scan``       — RG-LRU linear recurrence (recurrentgemma prefill, training)
* ``rglru_scan_bwd``   — its gradient (training; in the same module)

The public entry points are in ``ops``; the submodule names stay free for
the modules, so ``kernels.flash_attention.launches`` is the counter.
``KERNELS`` maps each kernel's name to its module and the name of its
counter there.
"""
from . import decode_attention, flash_attention, rglru_scan, ssd_scan

KERNELS = {"flash_attention": (flash_attention, "launches"),
           "flash_attention_bwd": (flash_attention, "bwd_launches"),
           "decode_attention": (decode_attention, "launches"),
           "ssd_scan": (ssd_scan, "launches"), "ssd_scan_bwd": (ssd_scan, "bwd_launches"),
           "rglru_scan": (rglru_scan, "launches"),
           "rglru_scan_bwd": (rglru_scan, "bwd_launches")}


def reset_launches() -> None:
    for mod, counter in KERNELS.values():
        setattr(mod, counter, 0)


def launch_counts() -> dict:
    return {name: getattr(mod, counter) for name, (mod, counter) in KERNELS.items()}


__all__ = ["KERNELS", "reset_launches", "launch_counts"]
