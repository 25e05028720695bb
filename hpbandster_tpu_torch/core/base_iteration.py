"""Alias module: the reference exposes these classes at
``core/base_iteration.py`` (SURVEY.md §1 layer map); kept here so migrating
imports work unchanged."""

from hpbandster_tpu_torch.core.iteration import BaseIteration, Datum, Status  # noqa: F401
