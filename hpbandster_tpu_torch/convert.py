"""State carried between the reference and the port.

This system has no weights: its state is the space codec, the fitted KDEs
and the warm observation buffers. These functions turn the reference's
numpy values (``np.asarray`` of its arrays) into the port's forms, so both
sides can compute on the same state. ``FusedBOHB`` uses
:func:`warm_obs_from_numpy` to upload its own warm observations.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.ops.kde import KDE
from hpbandster_tpu_torch.ops.sweep import SpaceCodec

__all__ = ["codec_from_numpy", "kde_from_numpy", "warm_obs_from_numpy"]


def codec_from_numpy(kind, log, lower, upper, q, cards, vartypes, logits) -> SpaceCodec:
    """A port codec from a reference ``SpaceCodec``'s arrays (same field
    order, so ``codec_from_numpy(*ref_codec)`` works), with the reference's
    dtypes."""
    return SpaceCodec(
        kind=np.asarray(kind, np.int32),
        log=np.asarray(log, bool),
        lower=np.asarray(lower, np.float64),
        upper=np.asarray(upper, np.float64),
        q=np.asarray(q, np.float64),
        cards=np.asarray(cards, np.int32),
        vartypes=np.asarray(vartypes, np.int32),
        logits=np.asarray(logits, np.float32),
    )


def kde_from_numpy(data, mask, bw, device: Optional[torch.device] = None) -> KDE:
    """A port ``KDE`` of float32 tensors on ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return KDE(t(data), t(mask), t(bw))


def warm_obs_from_numpy(
    warm_v: Mapping[float, np.ndarray],
    warm_l: Mapping[float, np.ndarray],
    device: Optional[torch.device] = None,
) -> Tuple[Dict[float, torch.Tensor], Dict[float, torch.Tensor]]:
    """Per-budget warm observations (``FusedBOHB._warm_v``/``_warm_l``:
    budget -> ``[n, d]`` vectors / ``[n]`` losses) as float32 tensors on
    ``device``, keyed by float budget."""
    vs = {
        float(b): torch.as_tensor(np.array(v, np.float32), device=device)
        for b, v in warm_v.items()
    }
    ls = {
        float(b): torch.as_tensor(np.array(warm_l[b], np.float32), device=device)
        for b in warm_v
    }
    return vs, ls
