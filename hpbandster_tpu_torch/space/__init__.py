"""Search-space module: typed hyperparameters + unit-hypercube array codec.

Self-contained replacement for the reference's external ConfigSpace
dependency (SURVEY.md §2 L0 / "Config / flag system").

Ported from ``hpbandster_tpu/space/__init__.py``: a numpy-only copy, so the
PyTorch package never imports the JAX package.
"""

from hpbandster_tpu_torch.space.hyperparameters import (  # noqa: F401
    Hyperparameter,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
    CategoricalHyperparameter,
    OrdinalHyperparameter,
    Constant,
)
from hpbandster_tpu_torch.space.conditions import (  # noqa: F401
    Condition,
    EqualsCondition,
    NotEqualsCondition,
    InCondition,
    GreaterThanCondition,
    LessThanCondition,
    AndConjunction,
    OrConjunction,
)
from hpbandster_tpu_torch.space.forbidden import (  # noqa: F401
    ForbiddenClause,
    ForbiddenEqualsClause,
    ForbiddenInClause,
    ForbiddenAndConjunction,
)
from hpbandster_tpu_torch.space.configspace import (  # noqa: F401
    Configuration,
    ConfigurationSpace,
    VARTYPE_CODES,
)
