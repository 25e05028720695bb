"""Device selection for the PyTorch package.

The port's entry points run on the GPU unless the caller names another
device. There is no silent fallback: asking for the default device on a
machine without CUDA raises, so a run that was meant for the card never
quietly measures the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "upload"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device on a machine without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def upload(device: torch.device, *arrays) -> List[torch.Tensor]:
    """Host arrays to ``device`` as float32 tensors of their shapes, in one
    copy: each is a view of one buffer. On a card the copy goes from pinned
    memory without blocking, so it queues behind the stream's work instead
    of synchronising the host with the card."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    host = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    if device.type == "cuda":
        host = host.pin_memory()
    buf = host.to(device, non_blocking=True)
    out, off = [], 0
    for a in arrays:
        out.append(buf[off:off + a.size].view(a.shape))
        off += a.size
    return out
