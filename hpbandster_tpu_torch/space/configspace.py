"""ConfigurationSpace — the typed search space and its array codec.

Replaces the reference's hard dependency on the external ``ConfigSpace``
library (SURVEY.md §2, L0 substrate) with a self-contained module whose
center of gravity is the **vector codec**: every configuration maps
bijectively (up to quantization) to a dense ``float64`` vector with

* continuous / integer dims in ``[0, 1]``,
* categorical / ordinal dims holding the choice index,
* ``NaN`` marking conditionally-inactive dims.

Everything downstream — the BOHB KDE (``ops/kde.py``), the batched
evaluation backends (``parallel/``) — consumes these vectors, never dicts.

Ported from ``hpbandster_tpu/space/configspace.py``: a numpy-only copy, so the
PyTorch package never imports the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from hpbandster_tpu_torch.obs.metrics import get_metrics
from hpbandster_tpu_torch.space.conditions import Condition
from hpbandster_tpu_torch.space.forbidden import ForbiddenClause
from hpbandster_tpu_torch.space.hyperparameters import (
    Hyperparameter,
    UniformFloatHyperparameter,
)

__all__ = ["Configuration", "ConfigurationSpace", "VARTYPE_CODES"]

#: integer codes for the per-dim vartype arrays handed to the device kernels
VARTYPE_CODES = {"c": 0, "u": 1, "o": 2}


#: a non-finite cell of a column: ``from_vectors`` leaves its key out
_MISSING = object()


def _clamp_column(x: np.ndarray, lower, upper) -> np.ndarray:
    """``hyperparameters._clamp`` element by element: ``min(max(x, lower),
    upper)`` with Python's comparisons, so equal values (and signed zeros)
    keep the side ``_clamp`` keeps."""
    x = np.where(lower > x, lower, x)
    return np.where(upper < x, upper, x)


def _decode_column(hp: Hyperparameter, u: np.ndarray) -> List[Any]:
    """``[hp.from_unit(x) for x in u]`` over a finite float64 column.

    numpy decodes the linear float without a quantum, whose column
    arithmetic is ``from_unit``'s IEEE operations in ``from_unit``'s order.
    Every other kind maps the scalar code over the column: numpy's ``exp``
    and ``log`` need not round as ``math``'s do. The values each branch
    decodes count in ``space.decode_values.numpy`` / ``.mapped``."""
    if type(hp) is UniformFloatHyperparameter and not hp.log and hp.q is None:
        get_metrics().counter("space.decode_values.numpy").inc(len(u))
        v = hp.lower + _clamp_column(u, 0.0, 1.0) * (hp.upper - hp.lower)
        return _clamp_column(v, hp.lower, hp.upper).tolist()
    get_metrics().counter("space.decode_values.mapped").inc(len(u))
    return [hp.from_unit(x) for x in u.tolist()]


class Configuration(dict):
    """A sampled configuration. A plain dict plus ConfigSpace-compatible sugar.

    The reference's user code calls ``.get_dictionary()`` on ConfigSpace
    ``Configuration`` objects (SURVEY.md §3.1); plain-dict inheritance keeps
    both idioms (`config['x']` and `config.get_dictionary()['x']`) working.
    """

    def get_dictionary(self) -> Dict[str, Any]:
        return dict(self)


class ConfigurationSpace:
    """An ordered collection of hyperparameters, conditions, and forbiddens."""

    def __init__(self, seed: Optional[int] = None, name: Optional[str] = None):
        self.name = name
        self._hps: Dict[str, Hyperparameter] = {}
        self._order: List[str] = []
        self._conditions: List[Condition] = []
        self._forbiddens: List[ForbiddenClause] = []
        self._rng = np.random.default_rng(seed)
        self._topo_cache: Optional[List[str]] = None

    # ------------------------------------------------------------------ build
    def add_hyperparameter(self, hp: Hyperparameter) -> Hyperparameter:
        if not isinstance(hp, Hyperparameter):
            raise TypeError(f"expected Hyperparameter, got {type(hp).__name__}")
        if hp.name in self._hps:
            raise ValueError(f"duplicate hyperparameter {hp.name!r}")
        self._hps[hp.name] = hp
        self._order.append(hp.name)
        self._topo_cache = None
        return hp

    def add_hyperparameters(self, hps: Iterable[Hyperparameter]) -> List[Hyperparameter]:
        return [self.add_hyperparameter(hp) for hp in hps]

    # ConfigSpace >=0.6 spells these `add`; accept both.
    add = add_hyperparameter

    def add_condition(self, condition: Condition) -> Condition:
        if condition.child_name not in self._hps:
            raise ValueError(f"unknown child {condition.child_name!r}")
        for p in condition.parents():
            if p not in self._hps:
                raise ValueError(f"unknown parent {p!r}")
        self._conditions.append(condition)
        self._topo_cache = None
        return condition

    def add_conditions(self, conditions: Iterable[Condition]) -> List[Condition]:
        return [self.add_condition(c) for c in conditions]

    def add_forbidden_clause(self, clause: ForbiddenClause) -> ForbiddenClause:
        self._forbiddens.append(clause)
        return clause

    def add_forbidden_clauses(self, clauses: Iterable[ForbiddenClause]):
        return [self.add_forbidden_clause(c) for c in clauses]

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ views
    def get_hyperparameters(self) -> List[Hyperparameter]:
        return [self._hps[n] for n in self._order]

    def get_hyperparameter_names(self) -> List[str]:
        return list(self._order)

    def get_hyperparameter(self, name: str) -> Hyperparameter:
        try:
            return self._hps[name]
        except KeyError:
            raise KeyError(f"no hyperparameter {name!r} in space") from None

    def get_conditions(self) -> List[Condition]:
        return list(self._conditions)

    def get_forbiddens(self) -> List[ForbiddenClause]:
        return list(self._forbiddens)

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, name: str) -> bool:
        return name in self._hps

    @property
    def dim(self) -> int:
        return len(self._order)

    # ----------------------------------------------------------- structure
    def _conditions_for(self, child: str) -> List[Condition]:
        return [c for c in self._conditions if c.child_name == child]

    def _topological_order(self) -> List[str]:
        """Hyperparameter names, parents before conditioned children.

        Stable w.r.t. insertion order among unconstrained nodes.
        """
        if self._topo_cache is not None:
            return self._topo_cache
        deps: Dict[str, set] = {n: set() for n in self._order}
        for c in self._conditions:
            deps[c.child_name].update(c.parents())
        out: List[str] = []
        ready = [n for n in self._order if not deps[n]]
        remaining = {n: set(d) for n, d in deps.items() if d}
        while ready:
            n = ready.pop(0)
            out.append(n)
            newly = []
            for m, d in list(remaining.items()):
                d.discard(n)
                if not d:
                    newly.append(m)
                    del remaining[m]
            # preserve declaration order among newly-ready nodes
            ready.extend(sorted(newly, key=self._order.index))
            ready.sort(key=self._order.index)
        if remaining:
            raise ValueError(f"cyclic conditions among {sorted(remaining)}")
        self._topo_cache = out
        return out

    def _active_set(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """Filter ``values`` down to the conditionally-active subset."""
        active: Dict[str, Any] = {}
        for name in self._topological_order():
            if name not in values:
                continue
            conds = self._conditions_for(name)
            if all(c.evaluate(active) for c in conds):
                active[name] = values[name]
        return active

    def is_forbidden(self, values: Dict[str, Any]) -> bool:
        return any(f.is_forbidden(values) for f in self._forbiddens)

    # ------------------------------------------------------------------ codec
    def to_vector(self, config: Dict[str, Any]) -> np.ndarray:
        """Config dict -> ``float64[dim]`` vector; inactive dims are NaN."""
        config = dict(config)
        vec = np.full(self.dim, np.nan, dtype=np.float64)
        active = self._active_set(config)
        for i, name in enumerate(self._order):
            if name in active:
                vec[i] = self._hps[name].to_unit(active[name])
        return vec

    def from_vector(self, vector: Sequence[float]) -> Configuration:
        """Vector -> config dict, deactivating conditionally-inactive dims.

        Mirrors the reference BOHB generator's ConfigSpace round-trip
        ("deactivate-inactive + to dict", SURVEY.md §3.4): every finite dim is
        decoded, then conditions prune inactive children top-down.
        """
        vector = np.asarray(vector, dtype=np.float64)
        if vector.shape != (self.dim,):
            raise ValueError(f"expected shape ({self.dim},), got {vector.shape}")
        raw: Dict[str, Any] = {}
        for i, name in enumerate(self._order):
            if np.isfinite(vector[i]):
                raw[name] = self._hps[name].from_unit(float(vector[i]))
        return Configuration(self._active_set(raw))

    def from_vectors(self, matrix: Sequence[Sequence[float]]) -> List[Configuration]:
        """Rows of ``matrix`` -> configs: ``[self.from_vector(v) for v in
        matrix]``, equal in values, Python types and key order, decoded a
        column at a time (one ``_decode_column`` per hyperparameter).

        A space without conditions zips the columns into rows as they are;
        one with conditions prunes each row through ``_active_set``, as
        ``from_vector`` does. Each call adds its rows to the
        ``space.decode_rows`` counter and its seconds to ``space.decode_s``."""
        t0 = time.perf_counter()
        out = self._from_vectors(matrix)
        metrics = get_metrics()
        metrics.counter("space.decode_s").inc(time.perf_counter() - t0)
        metrics.counter("space.decode_rows").inc(len(out))
        return out

    def _from_vectors(self, matrix) -> List[Configuration]:
        matrix = np.asarray(matrix, dtype=np.float64)
        if matrix.ndim != 2 or matrix.shape[1] != self.dim:
            raise ValueError(f"expected shape (n, {self.dim}), got {matrix.shape}")
        finite = np.isfinite(matrix)
        columns = []
        for i, name in enumerate(self._order):
            col, ok = matrix[:, i], finite[:, i]
            if ok.all():
                columns.append(_decode_column(self._hps[name], col))
            else:
                # a non-finite cell decodes to nothing, as in from_vector
                values = iter(_decode_column(self._hps[name], col[ok]))
                columns.append([next(values) if o else _MISSING for o in ok.tolist()])
        names = self._order
        if not columns:
            rows = ({} for _ in range(len(matrix)))
        elif finite.all():
            rows = (zip(names, vals) for vals in zip(*columns))
        else:
            rows = ({n: v for n, v in zip(names, vals) if v is not _MISSING}
                    for vals in zip(*columns))
        if self._conditions:
            return [Configuration(self._active_set(dict(raw))) for raw in rows]
        return [Configuration(raw) for raw in rows]

    def vartypes(self) -> np.ndarray:
        """``int32[dim]`` of VARTYPE_CODES ('c'=0, 'u'=1, 'o'=2)."""
        return np.asarray(
            [VARTYPE_CODES[self._hps[n].vartype] for n in self._order], dtype=np.int32
        )

    def cardinalities(self) -> np.ndarray:
        """``int32[dim]``: number of choices per dim (0 for continuous)."""
        return np.asarray(
            [self._hps[n].num_choices for n in self._order], dtype=np.int32
        )

    # --------------------------------------------------------------- sampling
    def sample_configuration(
        self, size: Optional[int] = None, rng: Optional[np.random.Generator] = None
    ) -> Union[Configuration, List[Configuration]]:
        """Uniform sample(s) respecting conditions and forbiddens."""
        rng = rng or self._rng
        n = 1 if size is None else int(size)
        out: List[Configuration] = []
        for _ in range(n):
            for _attempt in range(1000):
                values = {
                    name: self._hps[name].sample(rng)
                    for name in self._order
                }
                cfg = Configuration(self._active_set(values))
                if not self.is_forbidden(cfg):
                    out.append(cfg)
                    break
            else:
                raise RuntimeError(
                    "could not sample a non-forbidden configuration in 1000 tries"
                )
        return out[0] if size is None else out

    def sample_vectors(
        self, n: int, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """Sample ``n`` configurations directly as a ``float64[n, dim]`` batch."""
        rng = rng or self._rng
        return np.stack([self.to_vector(c) for c in self.sample_configuration(n, rng)])

    def get_default_configuration(self) -> Configuration:
        values = {n: self._hps[n].default_value for n in self._order}
        cfg = Configuration(self._active_set(values))
        if self.is_forbidden(cfg):
            raise ValueError("default configuration is forbidden")
        return cfg

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ConfigurationSpace({self.name or ''}, dim={self.dim}, "
            f"conditions={len(self._conditions)}, forbiddens={len(self._forbiddens)})"
        )
