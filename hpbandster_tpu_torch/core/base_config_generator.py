"""Alias module: the reference exposes the generator interface at
``core/base_config_generator.py`` (SURVEY.md §1 layer map); kept here so
migrating imports work unchanged."""

from hpbandster_tpu_torch.models.base import base_config_generator  # noqa: F401
