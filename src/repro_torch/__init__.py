"""PyTorch / CUDA port of the Dora substrate (see README.md)."""
import torch as _torch

# PyTorch's CPU build computes exp and log through MKL's vector math, which
# initialises itself on first use. When that first use is a call split
# across intra-op threads, one thread's share comes out about 1e-4 off
# (PyTorch 2.13 on the CPU, 2 threads: the first parallel torch.exp of a
# fresh process, in about one process in ten under load). These calls on
# tiny tensors run on one thread and initialise it before any parallel call.
_torch.exp(_torch.zeros(8))
_torch.exp(_torch.zeros(8, dtype=_torch.float64))
