"""Batched evaluation backend: a wave of configs -> losses.

Ported from ``hpbandster_tpu/parallel/backends.py`` (``VmapBackend``). The
objective takes the port's batched contract, the same as ``FusedBOHB``'s:
``eval_fn(vectors f32[n, d], budget) -> f32[n]`` with the budget a Python
float, so the ported workloads plug in unchanged. Non-finite losses mark
crashed configs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from hpbandster_tpu_torch.device import resolve_device, upload
from hpbandster_tpu_torch.obs.runtime import note_transfer
from hpbandster_tpu_torch.parallel.mesh import batch_sharding, mesh_device

__all__ = ["VmapBackend"]


class VmapBackend:
    """Evaluate a batched objective over a wave of config vectors on
    ``device`` (``None`` means ``cuda``, which raises where there is no
    card; with a mesh, the mesh's home device).

    Batches are padded with zero rows to a power of two of at least
    ``min_pad`` (and to a multiple of the mesh's size), as the reference
    pads, so the objective sees few distinct shapes and a library that
    picks its kernel by batch size picks the same one for every wave of a
    size class. With a mesh (``parallel/mesh.py``) each shard of ``axis``
    evaluates its block of the wave on its device; on a ``("config",
    "model")`` mesh the model axis replicates the batch. On a mesh over
    several processes every rank evaluates its own shards and receives the
    others' losses, so each rank's host driver holds the whole loss vector.
    """

    def __init__(
        self,
        eval_fn: Callable[[torch.Tensor, float], torch.Tensor],
        mesh=None,
        axis: str = "config",
        min_pad: int = 8,
        device=None,
    ):
        self.eval_fn = eval_fn
        self.mesh = mesh
        self.axis = axis
        self.min_pad = int(min_pad)
        self.device = resolve_device(
            device if mesh is None or device is not None else mesh_device(mesh))
        self._split = None if mesh is None else batch_sharding(mesh, axis)

    @property
    def parallelism(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _padded_size(self, n: int) -> int:
        size = self.min_pad
        while size < n:
            size *= 2
        m = self.parallelism
        return ((size + m - 1) // m) * m

    def _losses(self, batch: torch.Tensor, budget: float) -> torch.Tensor:
        losses = self.eval_fn(batch, budget)
        if losses.shape != (batch.shape[0],):
            raise ValueError(
                f"eval_fn must return one loss per row, f32[{batch.shape[0]}], "
                f"got shape {tuple(losses.shape)}")
        return losses.to(torch.float32)

    def evaluate(self, vectors: np.ndarray, budget: float) -> np.ndarray:
        """``f32[n, d]`` config vectors -> ``f32[n]`` losses (NaN = crashed):
        one upload (no synchronisation), one batched call per shard, one
        fetch (the wave's one synchronisation)."""
        vectors = np.asarray(vectors, np.float32)
        n, d = vectors.shape
        padded = np.zeros((self._padded_size(n), d), np.float32)
        padded[:n] = vectors
        note_transfer("h2d", padded.nbytes)
        (batch,) = upload(self.device, padded)
        budget = float(budget)
        if self._split is None:
            losses = self._losses(batch, budget)
        else:
            losses = self._split.map(lambda rows: self._losses(rows, budget), batch)
        out = losses.cpu().numpy()
        note_transfer("d2h", out.nbytes)
        return out[:n]
