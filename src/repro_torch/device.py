"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point of the port takes a ``device``.  ``None`` means the first
CUDA device; asking for CUDA on a machine without a card raises instead of
carrying on on the CPU (a CPU run must be asked for by name, as the tests
do with ``device="cpu"``).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """``None`` -> ``cuda:0``; a CUDA request without a card raises."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on the device's current stream (the
    counterpart of ``jax.block_until_ready`` around a timed span); no-op on
    the CPU.  Only the calling thread's stream: under BSP's parallel
    dispatch each executor thread runs on a stream of its own, and a
    device-wide wait would put the other threads' work into its span."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def as_tensor(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``.  numpy's bf16 —
    the ``ml_dtypes`` extension type JAX arrays convert to — is
    reinterpreted bit for bit, since ``torch.as_tensor`` cannot read it."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)
