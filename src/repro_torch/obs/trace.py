"""Structured span tracing for the QUIP engine (the reference's
docs/observability.md).

A :class:`Tracer` handed to :class:`~repro_torch.imputers.base.ImputationService`
(``tracer=``) records the executor's span tree — operator → impute flush →
kernel dispatch.  The engine otherwise holds the shared disabled
:data:`NULL_TRACER`.

Design constraints, in order:

* **Zero-allocation no-op mode.**  A disabled tracer must be free on the
  morsel hot path.  ``Tracer.span(...)`` returns the shared
  :data:`NULL_SPAN` singleton when disabled, and every hot call site
  additionally guards with ``if tracer.enabled`` so the keyword-argument
  dict is never even built.
* **Deterministic structure.**  ``clock="unit"`` replaces ``perf_counter``
  with a lock-guarded monotone tick, so tests assert on span *counts*
  (:meth:`Tracer.span_counts`), never on wall time.
* **Thread safety.**  Spans nest through a thread-local parent stack; the
  record list and the unit tick are guarded by one lock.

The reference's serving-layer parts (cross-thread ``begin``/``end`` query
spans, instants, Chrome trace export, the ``QUIP_TRACE`` gate) return with
the port of the serving stack.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, List, Optional

from repro_torch.analysis.lockcheck import make_lock

__all__ = ["NULL_SPAN", "NULL_TRACER", "Span", "Tracer", "TRACE_CLOCKS"]

TRACE_CLOCKS = ("wall", "unit")


class _NullSpan:
    """The shared no-op span: context manager + ``set`` sink.

    A singleton (:data:`NULL_SPAN`) so the disabled path allocates
    nothing — every ``with tracer.span(...)`` site reuses this object."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One recorded span.  ``t0``/``t1`` are seconds under the wall clock
    and bare ticks under the unit clock."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "thread", "t0",
                 "t1", "args")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 cat: str, thread: str, t0: float, args: Dict[str, object]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.thread = thread
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args


class _LiveSpan:
    """Context-manager handle for one open span on the current thread."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def set(self, **attrs) -> "_LiveSpan":
        self._span.args.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        self._tracer._push(self._span)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.args.setdefault("error", exc_type.__name__)
        self._tracer._pop(self._span)
        return False


class Tracer:
    """Thread-safe span recorder with a wall or deterministic unit clock.

    ``enabled=False`` makes every recording call a no-op returning
    :data:`NULL_SPAN`."""

    def __init__(self, enabled: bool = True, clock: str = "wall"):
        if clock not in TRACE_CLOCKS:
            raise ValueError(f"unknown trace clock {clock!r}; "
                             f"expected one of {TRACE_CLOCKS}")
        self.enabled = bool(enabled)
        self.clock = clock
        self._lock = make_lock("Tracer._lock")
        self._records: List[Span] = []  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock
        self._origin = time.perf_counter()
        self._tls = threading.local()

    # -- clock / ids ------------------------------------------------------#
    def now(self) -> float:
        if self.clock == "unit":
            with self._lock:
                self._tick += 1
                return float(self._tick)
        return time.perf_counter() - self._origin

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    # -- thread-local span stack ------------------------------------------#
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        span.t1 = self.now()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        with self._lock:
            self._records.append(span)

    def _parent(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- recording API ----------------------------------------------------#
    def span(self, name: str, cat: str = "exec", **args):
        """Open a nested span on this thread; use as a context manager.
        Disabled tracers return :data:`NULL_SPAN` (shared, allocation-free)."""
        if not self.enabled:
            return NULL_SPAN
        top = self._parent()
        return _LiveSpan(self, Span(
            self._new_id(), None if top is None else top.span_id, name, cat,
            threading.current_thread().name, self.now(), args,
        ))

    # -- introspection ----------------------------------------------------#
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Recorded spans, oldest first, optionally filtered by name."""
        with self._lock:
            records = list(self._records)
        records.sort(key=lambda s: (s.t0, s.span_id))
        if name is not None:
            records = [s for s in records if s.name == name]
        return records

    def span_counts(self) -> Dict[str, int]:
        """``{span name: count}`` — the structural fingerprint tests assert
        on under the unit clock (no wall time anywhere)."""
        return dict(Counter(s.name for s in self.spans()))


#: the shared disabled tracer — the default wiring when observability is
#: off, so layers can hold a tracer unconditionally (no None checks)
NULL_TRACER = Tracer(enabled=False)
