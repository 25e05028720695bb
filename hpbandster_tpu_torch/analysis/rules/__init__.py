"""The port's graftlint rule pack — importing this package registers every
rule.

Add a rule by dropping a module here that defines a ``Rule`` subclass
decorated with ``@register`` and importing it below. The generic rules
(``exceptions``, ``locks``, ``lockorder``, ``obs_reserved``, ``retry``,
``wallclock``) are the reference's; the others are the torch counterparts
of its JAX rules.
"""

from hpbandster_tpu_torch.analysis.rules import (  # noqa: F401
    capture_escape,
    capture_loop,
    capture_purity,
    capture_rebind,
    exceptions,
    generator,
    lockorder,
    locks,
    markers,
    obs_emit,
    obs_reserved,
    retry,
    wallclock,
)
