"""``hpbandster_tpu_torch.promote`` — the promotion-rule subsystem.

Ported from ``hpbandster_tpu/promote``. Decouples "when does a config
advance" from the bracket loop: the paper's synchronous successive-halving
barrier (``core/successive_halving.py``) is one rule among several behind
one interface, an iteration class the optimizer instantiates per bracket,
selectable by name: ``BOHB(promotion_rule="asha")``.

Rules (see docs/promotion.md for the semantics and math):

* ``successive_halving`` / ``sync`` — the paper's barrier rule: wait for
  the full rung, promote the top ``num_configs[stage+1]`` by loss;
  ``successive_halving_jax`` keeps the reference's name and decides the
  mask on a torch device (the optimizer's);
* ``asha`` — asynchronous successive halving
  (:class:`~hpbandster_tpu_torch.promote.asha.ASHAIteration`): a config is
  promoted the moment it enters the top ``1/eta`` of its rung's completed
  results, no barrier;
* ``pareto`` — multi-objective promotion
  (:class:`~hpbandster_tpu_torch.promote.pareto.ParetoIteration`): rungs
  rank on (loss, measured evaluation cost) by the Pareto-front top-k of
  ``ops/bracket.py``; crashed rows never promote;
* ``lc_earlystop`` — learning-curve early stopping
  (:class:`~hpbandster_tpu_torch.promote.earlystop.LCEarlyStopIteration`):
  the power-law extrapolation terminates configs whose predicted
  final-budget loss cannot reach the current cut.

Every rule emits the same ``promotion_decision`` audit records (with its
own ``rule`` name), and :mod:`~hpbandster_tpu_torch.promote.replay`
re-scores any recorded journal under any rule, byte-identical across
invocations.

This module is import-light (standard library only): a caller can validate
rule names against :data:`RULE_NAMES` without the implementations;
:func:`resolve_rule` imports lazily.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["RULE_NAMES", "resolve_rule"]

#: rule name -> (module, class). Lazy: resolving imports the module.
_RULES: Dict[str, Tuple[str, str]] = {
    "successive_halving": (
        "hpbandster_tpu_torch.core.successive_halving", "SuccessiveHalving"
    ),
    "sync": (
        "hpbandster_tpu_torch.core.successive_halving", "SuccessiveHalving"
    ),
    "successive_halving_jax": (
        "hpbandster_tpu_torch.core.successive_halving", "JaxSuccessiveHalving"
    ),
    "asha": ("hpbandster_tpu_torch.promote.asha", "ASHAIteration"),
    "pareto": ("hpbandster_tpu_torch.promote.pareto", "ParetoIteration"),
    "lc_earlystop": (
        "hpbandster_tpu_torch.promote.earlystop", "LCEarlyStopIteration"
    ),
}

#: the selectable vocabulary
RULE_NAMES: Tuple[str, ...] = tuple(sorted(_RULES))


def resolve_rule(name: str) -> type:
    """Promotion-rule name -> iteration class (lazy import).

    Raises ``ValueError`` with the known vocabulary on an unknown name.
    """
    try:
        module_name, attr = _RULES[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown promotion rule {name!r} (supported: {RULE_NAMES})"
        ) from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
