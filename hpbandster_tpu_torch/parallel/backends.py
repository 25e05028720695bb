"""Batched evaluation backend: a wave of configs -> losses on one device.

Ported from ``hpbandster_tpu/parallel/backends.py`` (``VmapBackend``, one
device). The objective takes the port's batched contract, the same as
``FusedBOHB``'s: ``eval_fn(vectors f32[n, d], budget) -> f32[n]`` with the
budget a Python float, so the ported workloads plug in unchanged. Non-finite
losses mark crashed configs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device, upload

__all__ = ["VmapBackend"]


class VmapBackend:
    """Evaluate a batched objective over a wave of config vectors on
    ``device`` (``None`` means ``cuda``, which raises where there is no
    card).

    Batches are padded with zero rows to a power of two of at least
    ``min_pad``, as the reference pads, so the objective sees few distinct
    shapes and a library that picks its kernel by batch size picks the
    same one for every wave of a size class. ``mesh=`` (sharding a wave
    over several devices) is not ported yet.
    """

    def __init__(
        self,
        eval_fn: Callable[[torch.Tensor, float], torch.Tensor],
        mesh=None,
        min_pad: int = 8,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "VmapBackend(mesh=...) is not ported yet (ROADMAP A7: multi-GPU)")
        self.eval_fn = eval_fn
        self.min_pad = int(min_pad)
        self.device = resolve_device(device)

    @property
    def parallelism(self) -> int:
        return 1

    def _padded_size(self, n: int) -> int:
        size = self.min_pad
        while size < n:
            size *= 2
        return size

    def evaluate(self, vectors: np.ndarray, budget: float) -> np.ndarray:
        """``f32[n, d]`` config vectors -> ``f32[n]`` losses (NaN = crashed):
        one upload (no synchronisation), one batched call, one fetch (the
        wave's one synchronisation)."""
        vectors = np.asarray(vectors, np.float32)
        n, d = vectors.shape
        padded = np.zeros((self._padded_size(n), d), np.float32)
        padded[:n] = vectors
        (batch,) = upload(self.device, padded)
        losses = self.eval_fn(batch, float(budget))
        if losses.shape != (padded.shape[0],):
            raise ValueError(
                f"eval_fn must return one loss per row, f32[{padded.shape[0]}], "
                f"got shape {tuple(losses.shape)}")
        return losses.to(torch.float32).cpu().numpy()[:n]
