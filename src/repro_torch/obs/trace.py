"""Structured span tracing for the QUIP serving stack (docs/observability.md).

One :class:`Tracer` per :class:`~repro_torch.service.server.QuipService` records a
per-query span tree — submit → admission → scheduler checkout/checkin →
morsel step → operator → impute flush → kernel dispatch — and exports it as
Chrome trace-event JSON (loadable in ``chrome://tracing`` / Perfetto).

Design constraints, in order:

* **Zero-allocation no-op mode.**  A disabled tracer must be free on the
  morsel hot path.  ``Tracer.span(...)`` returns the shared
  :data:`NULL_SPAN` singleton when disabled, and every hot call site
  additionally guards with ``if tracer.enabled`` so the keyword-argument
  dict is never even built.
* **Deterministic structure.**  ``clock="unit"`` replaces ``perf_counter``
  with a lock-guarded monotone tick, so tests assert on span *counts and
  nesting* (:meth:`span_counts`, :meth:`span_tree`), never on wall time.
* **Thread safety.**  Spans nest through a thread-local parent stack
  (worker threads each get their own); the record list and the unit tick
  are guarded by one lock.  Cross-thread spans (a query's submit→finalize
  lifetime) use the explicit :meth:`begin`/:meth:`end` pair, which does not
  touch any thread's stack.

Per-query attribution: a span created with ``ticket=`` stamps it; nested
spans without one inherit the nearest enclosing span's ticket on the same
thread.  ``chrome_trace(ticket=...)`` exports one query's tree.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, List, Optional

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.core.env import env_choice, env_flag

__all__ = [
    "NULL_SPAN",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "TRACE_CLOCKS",
    "resolve_tracer",
]

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
    """One recorded event: a completed span (``ph="X"``) or an instant
    (``ph="i"``).  ``t0``/``t1`` are seconds under the wall clock and bare
    ticks under the unit clock."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "ticket",
                 "thread", "t0", "t1", "args", "ph")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 cat: str, ticket: Optional[int], thread: str,
                 t0: float, args: Dict[str, object], ph: str = "X"):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.ticket = ticket
        self.thread = thread
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args
        self.ph = ph


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

    ``enabled=False`` (the default of :func:`resolve_tracer` without
    ``QUIPT_TRACE``) makes every recording call a no-op returning
    :data:`NULL_SPAN`."""

    def __init__(self, enabled: bool = True, clock: str = "wall"):
        if clock not in TRACE_CLOCKS:
            raise ValueError(f"unknown trace clock {clock!r}; "
                             f"expected one of {TRACE_CLOCKS}")
        self.enabled = bool(enabled)
        self.clock = clock
        self._lock = make_lock("Tracer._lock")
        self._records: List[Span] = []  # guarded-by: _lock
        self._open: Dict[int, Span] = {}  # guarded-by: _lock
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
    def span(self, name: str, cat: str = "exec",
             ticket: Optional[int] = None,
             parent: Optional[int] = None, **args):
        """Open a nested span on this thread; use as a context manager.
        Disabled tracers return :data:`NULL_SPAN` (shared, allocation-free).
        ``parent`` overrides the thread-local nesting (e.g. to hang morsel
        steps under a cross-thread :meth:`begin` query span)."""
        if not self.enabled:
            return NULL_SPAN
        top = self._parent()
        if parent is None and top is not None:
            parent = top.span_id
        if ticket is None and top is not None:
            ticket = top.ticket
        return _LiveSpan(self, Span(
            self._new_id(), parent, name, cat, ticket,
            threading.current_thread().name, self.now(), args,
        ))

    def instant(self, name: str, cat: str = "event",
                ticket: Optional[int] = None,
                parent: Optional[int] = None, **args) -> None:
        """Record a zero-duration event (scheduler checkout/checkin,
        admission...).  ``parent`` hangs the event under a cross-thread
        :meth:`begin` span — the scheduler passes the query span so its
        instants join the ticket's tree instead of floating as roots."""
        if not self.enabled:
            return
        top = self._parent()
        if parent is None and top is not None:
            parent = top.span_id
        if ticket is None and top is not None:
            ticket = top.ticket
        span = Span(self._new_id(), parent, name, cat, ticket,
                    threading.current_thread().name, self.now(), args,
                    ph="i")
        span.t1 = span.t0
        with self._lock:
            self._records.append(span)

    def begin(self, name: str, cat: str = "query",
              ticket: Optional[int] = None, **args) -> Optional[int]:
        """Open a cross-thread span (no thread-local nesting); returns its
        span id for :meth:`end`.  None when disabled."""
        if not self.enabled:
            return None
        span = Span(self._new_id(), None, name, cat, ticket,
                    threading.current_thread().name, self.now(), args)
        with self._lock:
            self._open[span.span_id] = span
        return span.span_id

    def end(self, span_id: Optional[int], **args) -> None:
        """Close a :meth:`begin` span (id None — disabled begin — is a
        no-op)."""
        if not self.enabled or span_id is None:
            return
        with self._lock:
            span = self._open.pop(span_id, None)
        if span is None:
            return
        span.args.update(args)
        span.t1 = self.now()
        with self._lock:
            self._records.append(span)

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self._open = {}
            self._tick = 0
            self._next_id = 0
        self._origin = time.perf_counter()

    # -- introspection ----------------------------------------------------#
    def spans(self, ticket: Optional[int] = None,
              name: Optional[str] = None) -> List[Span]:
        """Recorded spans, oldest first, optionally filtered by ticket
        and/or name."""
        with self._lock:
            records = list(self._records)
        records.sort(key=lambda s: (s.t0, s.span_id))
        if ticket is not None:
            records = [s for s in records if s.ticket == ticket]
        if name is not None:
            records = [s for s in records if s.name == name]
        return records

    def span_counts(self, ticket: Optional[int] = None) -> Dict[str, int]:
        """``{span name: count}`` — the structural fingerprint tests assert
        on under the unit clock (no wall time anywhere)."""
        return dict(Counter(s.name for s in self.spans(ticket)))

    def span_tree(self, ticket: Optional[int] = None) -> List[Dict]:
        """Nested ``{"name", "children"}`` forest ordered by start time —
        deterministic under ``clock="unit"`` with a serial scheduler."""
        records = self.spans(ticket)
        ids = {s.span_id for s in records}
        nodes = {s.span_id: {"name": s.name, "children": []} for s in records}
        roots: List[Dict] = []
        for s in records:
            node = nodes[s.span_id]
            if s.parent_id in ids:
                nodes[s.parent_id]["children"].append(node)
            else:
                roots.append(node)
        return roots

    # -- Chrome trace-event export ----------------------------------------#
    def chrome_trace(self, ticket: Optional[int] = None) -> Dict:
        """The whole service's (or one ticket's) trace as a Chrome
        trace-event JSON document: ``ph="X"`` complete events with µs
        timestamps, pid = ticket (0 for service-level spans), tid = a
        stable per-thread integer, plus ``ph="M"`` metadata naming every
        process and thread.  Unit-clock ticks export as 1 µs each."""
        records = self.spans(ticket)
        threads = {name: i + 1 for i, name in enumerate(
            sorted({s.thread for s in records})
        )}
        scale = 1.0 if self.clock == "unit" else 1e6  # → microseconds
        events: List[Dict] = []
        pids = sorted({s.ticket or 0 for s in records})
        for pid in pids:
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"ticket {pid}" if pid else "service"},
            })
        for name, tid in threads.items():
            for pid in pids:
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": name},
                })
        for s in records:
            ev = {
                "name": s.name,
                "cat": s.cat,
                "ph": s.ph,
                "ts": s.t0 * scale,
                "pid": s.ticket or 0,
                "tid": threads[s.thread],
                "args": dict(s.args),
            }
            if s.ph == "X":
                ev["dur"] = max(((s.t1 or s.t0) - s.t0) * scale, 0.0)
            else:
                ev["s"] = "t"  # instant scope: thread
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"clock": self.clock, "tracer": "quip-obs"},
        }


#: the shared disabled tracer — the default wiring when observability is
#: off, so layers can hold a tracer unconditionally (no None checks)
NULL_TRACER = Tracer(enabled=False)


def resolve_tracer(tracer=None) -> Tracer:
    """Explicit :class:`Tracer` > bool > ``QUIPT_TRACE`` env (truthy/falsy
    via :func:`env_flag`, garbage raises) > off.  The clock comes from
    ``QUIPT_TRACE_CLOCK`` (``wall`` | ``unit``, via :func:`env_choice`)
    unless an explicit Tracer is handed in."""
    if isinstance(tracer, Tracer):
        return tracer
    clock = env_choice("QUIPT_TRACE_CLOCK", TRACE_CLOCKS, "wall")
    if tracer is None:
        enabled = env_flag("QUIPT_TRACE", False)
    else:
        enabled = bool(tracer)
    if not enabled:
        return NULL_TRACER
    return Tracer(enabled=True, clock=clock)
