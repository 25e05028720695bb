"""Trace context — one identity per job, carried across every hop.

Ported from ``hpbandster_tpu/obs/trace.py`` (a copy: the port imports
nothing of the JAX package). The RPC envelope helpers (``current_wire``,
``extract_wire``, ``extract_tenant``) serve the host tier
(``parallel/rpc.py``).

A distributed BOHB run is a relay: the master mints a job, the dispatcher
RPCs it to a worker on another host, the worker computes and RPCs the
result back. Each process journals its own half of the story; without a
shared identity those halves can never be re-joined. :class:`TraceContext`
is that identity: a ``run_id`` (the sweep), a ``trace_id`` (one job's
round-trip), and a ``hop`` counter (how many process boundaries the
context has crossed).

Plumbing rules:

* the *current* trace lives in a :mod:`contextvars` ContextVar — emitting
  sites never pass ``trace_id`` by hand (the ``obs-reserved-fields``
  graftlint rule forbids it); :func:`hpbandster_tpu_torch.obs.events.make_event`
  stamps it onto every event automatically;
* across RPC it rides as an optional ``_obs`` envelope field beside
  ``method``/``params`` (``parallel/rpc.py`` injects via
  :func:`current_wire` and extracts via :func:`extract_wire`). Old peers
  ignore the unknown key, so the wire stays backward compatible in both
  directions;
* threads do NOT inherit contextvars — code that hands work to another
  thread (``Worker._rpc_start_computation`` -> compute thread) must
  capture :func:`current_trace` and re-enter it with :func:`use_trace`.

Tenant identity (the serving tier, ``hpbandster_tpu_torch/serve``) follows the
same pattern in a SECOND ContextVar: :func:`use_tenant` makes a tenant id
current, :func:`make_event` stamps it as ``tenant_id`` on every event, and
:func:`current_wire` carries it in the same ``_obs`` envelope so the
dispatcher/worker side of a multi-tenant job journals under the right
tenant. No tenant context means no field anywhere — a single-tenant
journal stays byte-identical to the pre-serving format, and readers treat
a missing ``tenant_id`` as the ``"default"`` tenant (:data:`DEFAULT_TENANT`).


Stdlib-only, like the rest of ``obs``: importing this module pulls in no
torch/numpy and a no-trace :func:`current_wire` is one ContextVar read.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import uuid
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "TraceContext",
    "WIRE_FIELD",
    "DEFAULT_TENANT",
    "new_trace",
    "current_trace",
    "set_trace",
    "reset_trace",
    "use_trace",
    "current_tenant",
    "use_tenant",
    "current_run",
    "use_run",
    "current_wire",
    "extract_wire",
    "extract_tenant",
]

#: the envelope key trace context travels under in RPC messages
WIRE_FIELD = "_obs"

#: what a missing ``tenant_id`` means to every reader (journal filters,
#: report --tenant): the pre-serving single-tenant world IS this tenant
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One job's identity: which run, which job, how many hops so far."""

    run_id: str
    trace_id: str
    hop: int = 0


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "hpbandster_tpu_torch_obs_trace", default=None
)


def new_trace(run_id: str = "") -> TraceContext:
    """Mint a fresh trace identity (the master does this per job)."""
    return TraceContext(run_id=str(run_id), trace_id=uuid.uuid4().hex[:16], hop=0)


def current_trace() -> Optional[TraceContext]:
    """The trace active in this thread/context, or None."""
    return _CURRENT.get()


def set_trace(ctx: Optional[TraceContext]) -> contextvars.Token:
    """Make ``ctx`` current; returns the token for :func:`reset_trace`."""
    return _CURRENT.set(ctx)


def reset_trace(token: contextvars.Token) -> None:
    _CURRENT.reset(token)


@contextlib.contextmanager
def use_trace(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Run the body under ``ctx``. ``use_trace(None)`` is a no-op passthrough
    (callers never need to branch on 'do I have a trace?')."""
    if ctx is None:
        yield None
        return
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


# ----------------------------------------------------------------- tenant
_TENANT: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "hpbandster_tpu_torch_obs_tenant", default=None
)


def current_tenant() -> Optional[str]:
    """The tenant active in this thread/context, or None (single-tenant)."""
    return _TENANT.get()


@contextlib.contextmanager
def use_tenant(tenant: Optional[str]) -> Iterator[Optional[str]]:
    """Run the body under a tenant identity; events emitted inside carry
    ``tenant_id`` and outgoing RPC envelopes carry ``tenant``.
    ``use_tenant(None)`` is a no-op passthrough, exactly like
    :func:`use_trace` — single-tenant call sites never branch."""
    if tenant is None:
        yield None
        return
    token = _TENANT.set(str(tenant))
    try:
        yield tenant
    finally:
        _TENANT.reset(token)


# -------------------------------------------------------------------- run
#: the run (sweep) active in this thread/context. Unlike the trace (one
#: per JOB) this is one per MASTER drive loop: process-global state that
#: must not bleed between sequential or concurrent sweeps in one process
#: (the promotion-audit straggler ledger, obs/audit.py) keys on it. Not
#: stamped onto events — journal records already carry run identity
#: through their trace context where it matters.
_RUN: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "hpbandster_tpu_torch_obs_run", default=None
)


def current_run() -> Optional[str]:
    """The run id active in this thread/context, or None."""
    run = _RUN.get()
    if run is not None:
        return run
    # inside a job's trace the run identity is already known — the
    # fallback that lets bus sinks (anomaly detector) attribute without
    # their emitter having entered use_run explicitly
    ctx = _CURRENT.get()
    return ctx.run_id if ctx is not None and ctx.run_id else None


@contextlib.contextmanager
def use_run(run_id: Optional[str]) -> Iterator[Optional[str]]:
    """Run the body under a run (sweep) identity. ``use_run(None)`` is a
    no-op passthrough like :func:`use_trace` / :func:`use_tenant`."""
    if run_id is None:
        yield None
        return
    token = _RUN.set(str(run_id))
    try:
        yield run_id
    finally:
        _RUN.reset(token)


# ------------------------------------------------------------------- wire
def current_wire() -> Optional[Dict[str, Any]]:
    """The ``_obs`` envelope for an outgoing RPC: the current trace with
    its hop count advanced (plus the current tenant when one is active),
    or None when neither is set (the common case — two ContextVar reads,
    no allocation)."""
    ctx = _CURRENT.get()
    tenant = _TENANT.get()
    if ctx is None and tenant is None:
        return None
    wire: Dict[str, Any] = {}
    if ctx is not None:
        wire.update(
            run_id=ctx.run_id, trace_id=ctx.trace_id, hop=ctx.hop + 1
        )
    if tenant is not None:
        wire["tenant"] = tenant
    return wire


def extract_wire(wire: Any) -> Optional[TraceContext]:
    """Parse an incoming ``_obs`` envelope into a :class:`TraceContext`.

    Tolerant by contract: a missing, malformed, or future-shaped envelope
    yields None — a telemetry field must never fail an RPC."""
    if not isinstance(wire, dict):
        return None
    trace_id = wire.get("trace_id")
    if not isinstance(trace_id, str) or not trace_id:
        return None
    run_id = wire.get("run_id")
    hop = wire.get("hop")
    return TraceContext(
        run_id=run_id if isinstance(run_id, str) else "",
        trace_id=trace_id,
        hop=hop if isinstance(hop, int) and hop >= 0 else 0,
    )


def extract_tenant(wire: Any) -> Optional[str]:
    """The tenant id of an incoming ``_obs`` envelope, or None.

    Same tolerance contract as :func:`extract_wire`: a missing, malformed,
    or tenant-less envelope (every pre-serving peer) is simply no tenant.
    """
    if not isinstance(wire, dict):
        return None
    tenant = wire.get("tenant")
    return tenant if isinstance(tenant, str) and tenant else None
