"""Executor device placement.

The port's counterpart of the JAX executor mesh (``ops/exchange.py``
``make_mesh`` and the virtual 8-device CPU mesh of the JAX tests): one
``torch.device`` per executor, entries may repeat.  Entry points run on the
card unless the caller names the CPU; a missing card is an error, never a
silent fall back to the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def normalize_device(device) -> torch.device:
    """``torch.device`` with a bare ``cuda`` resolved to the current CUDA device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def resolve_devices(devices: Optional[Sequence], num_executors: Optional[int]) -> List[torch.device]:
    """One device per executor: ``devices`` as given, or ``cuda`` for each of
    ``num_executors`` executors.  Raises when CUDA is asked for (explicitly or
    by default) and is not available."""
    if devices is None:
        if num_executors is None or num_executors <= 0:
            raise ValueError("need num_executors or devices")
        devices = ["cuda"] * num_executors
    elif num_executors is not None and num_executors != len(devices):
        raise ValueError(f"num_executors={num_executors} != {len(devices)} devices")
    if not devices:
        raise ValueError("need at least one executor device")
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu'] * n to run the executors on the CPU"
            )
        out.append(normalize_device(d))
    return out


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device``.  To a CUDA device the copy goes
    through page-locked memory, queued on the calling thread's current
    stream, so the host does not wait for the work already queued there;
    PyTorch's page-locked allocator keeps the staging block from reuse until
    the copy has run.  On the CPU the tensor shares ``array``'s memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
