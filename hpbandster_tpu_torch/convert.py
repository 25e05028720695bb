"""State carried between the reference and the port.

The optimizer's state is the space codec, the fitted KDEs and the warm
observation buffers; the training workloads add datasets and initial
weights (:func:`dataset_from_numpy`, :func:`params_from_numpy`). These functions turn the reference's
numpy values (``np.asarray`` of its arrays) into the port's forms, so both
sides can compute on the same state. ``FusedBOHB`` uses
:func:`warm_obs_from_numpy` (static tier) and :func:`dynamic_obs_from_numpy`
(dynamic-count tier) to upload its own warm observations. A fused
checkpoint of the reference needs no conversion: its pickle holds only
Python and numpy values, and ``FusedBOHB.load_checkpoint`` reads it as it
is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hpbandster_tpu_torch.ops.kde import KDE
from hpbandster_tpu_torch.ops.sweep import SpaceCodec

__all__ = [
    "codec_from_numpy",
    "kde_from_numpy",
    "warm_obs_from_numpy",
    "dynamic_obs_from_numpy",
    "dataset_from_numpy",
    "params_from_numpy",
]


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


def dynamic_obs_from_numpy(
    warm_v_pad: Mapping[float, np.ndarray],
    warm_l_pad: Mapping[float, np.ndarray],
    warm_n: Mapping[float, int],
    device: Optional[torch.device] = None,
) -> Tuple[Dict[float, torch.Tensor], Dict[float, torch.Tensor], Dict[float, torch.Tensor]]:
    """The dynamic-count tier's warm inputs from the reference's padded
    buffers (budget -> full-capacity ``[cap, d]`` vectors, ``[cap]``
    losses, and a count): float32 buffers and int32 count tensors on
    ``device``, keyed by float budget, as ``make_fused_sweep_fn(...,
    dynamic_counts=True)`` takes them."""
    vs, ls = warm_obs_from_numpy(warm_v_pad, warm_l_pad, device)
    ns = {
        float(b): torch.as_tensor(int(warm_n[b]), dtype=torch.int32, device=device)
        for b in warm_v_pad
    }
    return vs, ls, ns


def dataset_from_numpy(data, device: Optional[torch.device] = None):
    """A workload's dataset from the reference's arrays (a nested tuple, as
    its ``make_*_dataset`` returns): float arrays as float32 tensors, images
    (4-D, NHWC) transposed to the port's NCHW, integer arrays (labels,
    tokens) as int64, on ``device``."""
    if isinstance(data, (tuple, list)):
        return tuple(dataset_from_numpy(x, device) for x in data)
    a = np.asarray(data)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    return torch.as_tensor(np.array(a, np.float32), device=device)


def params_from_numpy(tree, device: Optional[torch.device] = None):
    """A workload's parameter tree from the reference's (nested dicts of
    arrays): float32 tensors on ``device``, conv kernels (4-D) from the
    reference's HWIO to the port's OIHW. Pass the reference's
    initialisation at ``init_scale = 1`` as a workload's ``init=``: every
    initialiser is linear in ``init_scale`` (layer-norm gains excepted,
    which do not scale), and the port scales per config."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.as_tensor(np.array(a), device=device)
