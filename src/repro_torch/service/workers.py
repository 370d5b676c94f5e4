"""Threaded morsel worker pool for QuipService (docs/serving.md).

N daemon threads pull morsel steps from the service's MorselScheduler
through its checkout/checkin split: a worker takes the policy-chosen
session under the service lock (``MorselScheduler.next_session``), runs
exactly one ``session.step()`` **off** the lock, then checks it back in
(``checkin`` charges the tenant and requeues) and finalizes it if it
finished.  The policy layer already charges by per-step active time, so
wfq/deadline/quota semantics transfer unchanged — the pool only changes
*where* a step runs, never *which* step is charged what.  A checked-out
session is invisible to ``next_session``, so its generator is only ever
advanced by one thread at a time and per-session state needs no locks.

Intra-query parallelism: ``QuipExecutor`` fans order-independent sibling
morsels (join-free Select*(Scan) chains) through :meth:`map_morsels`.
The pool runs them as claimable units of a :class:`_TaskGroup`, and the
**owner helps**: the worker that opened the fan-out keeps claiming units
itself until none remain, then waits only for stragglers other workers
took — a pool of any size (including 1) can never deadlock on its own
sub-tasks.  Idle workers prefer units over checking out a new session,
so in-flight queries finish before new ones start consuming threads.

Lock discipline: everything the pool shares (scheduler queues, task
groups, the busy counter) lives under the service's single
RLock/Condition; stepping and unit execution happen outside it.  A
worker crash (a pool bug — ``session.step()`` already converts query
errors into FAILED sessions) is captured and re-raised by the next
``wait_idle``/``result`` instead of hanging the caller.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

__all__ = ["WorkerPool"]


class _TaskGroup:
    """One ``map_morsels`` fan-out: claimable units with ordered results."""

    __slots__ = ("fn", "items", "results", "next_unit", "done", "error")

    def __init__(self, fn: Callable, items: Sequence):
        self.fn = fn
        self.items = items
        self.results: List = [None] * len(items)
        self.next_unit = 0  # next unclaimed index (guarded by the pool cv)
        self.done = 0  # completed units (ditto)
        self.error: Optional[BaseException] = None  # first unit exception

    def claim(self) -> Optional[int]:
        """Take the next unclaimed unit index (call under the cv)."""
        if self.next_unit >= len(self.items):
            return None
        i = self.next_unit
        self.next_unit += 1
        return i

    @property
    def finished(self) -> bool:
        return self.done >= len(self.items)


class WorkerPool:
    """``size`` daemon threads stepping a QuipService's scheduler.

    Created by ``QuipService(..., workers=N)`` — not standalone: it
    drives the service's private checkout/checkin hooks and shares its
    RLock/Condition.  ``shutdown`` (via ``QuipService.close``) stops and
    joins the threads; drain first (``run_until_idle``) for a clean exit.
    """

    # cv.wait timeout: guards against lost wakeups without busy-spinning
    _POLL_S = 0.05

    def __init__(self, service, size: int):
        if size < 1:
            raise ValueError(f"worker pool size must be >= 1, got {size}")
        self._svc = service
        # the service's condition over the service RLock — the pool adds
        # no lock of its own, so lock-order cycles with service state are
        # impossible by construction
        self._cv: threading.Condition = service._cv
        self.size = int(size)
        self._groups: Deque[_TaskGroup] = deque()  # guarded-by: _cv
        self._busy = 0  # stepping/unit-running workers  # guarded-by: _cv
        self.steps_done = 0  # session steps run by the pool  # guarded-by: _cv
        self.units_done = 0  # fan-out units run by the pool  # guarded-by: _cv
        self._stop = False  # guarded-by: _cv
        self._crash: Optional[BaseException] = None  # guarded-by: _cv
        self._threads = [
            threading.Thread(target=self._worker, name=f"quip-worker-{i}",
                             daemon=True)
            for i in range(self.size)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------ #
    # worker loop
    # ------------------------------------------------------------------ #
    def _worker(self) -> None:
        try:
            while True:
                unit = session = None
                with self._cv:
                    if self._stop:
                        return
                    unit = self._claim_unit()
                    if unit is None:
                        session = self._svc._checkout_session()
                        if session is None:
                            self._cv.wait(self._POLL_S)
                            continue
                    self._busy += 1
                try:
                    if unit is not None:
                        group, i = unit
                        self._run_unit(group, i)
                    else:
                        finished = session.step()  # OFF the lock
                        with self._cv:
                            self._svc._checkin_session(session, finished)
                finally:
                    with self._cv:
                        self._busy -= 1
                        if unit is not None:
                            self.units_done += 1
                        else:
                            self.steps_done += 1
                        self._cv.notify_all()
        except BaseException as e:  # pool bug: surface, don't hang callers
            with self._cv:
                self._crash = e
                self._cv.notify_all()

    def _claim_unit(self):  # requires: _cv
        """Next (group, index) unit, dropping fully-claimed groups (call
        under the cv)."""
        while self._groups:
            group = self._groups[0]
            i = group.claim()
            if i is None:
                self._groups.popleft()
                continue
            return group, i
        return None

    def _run_unit(self, group: _TaskGroup, i: int) -> None:
        try:
            result = group.fn(group.items[i])
            err = None
        except Exception as e:  # surfaced by the owner, once, in order
            result, err = None, e
        with self._cv:
            group.results[i] = result
            if err is not None and group.error is None:
                group.error = err
            group.done += 1
            self._cv.notify_all()

    # ------------------------------------------------------------------ #
    # intra-query fan-out (executor task_runner)
    # ------------------------------------------------------------------ #
    def map_morsels(self, fn: Callable, items: Sequence) -> List:
        """Run ``fn`` over ``items``, order-preserving, possibly on other
        workers.  Called from a worker mid-``session.step()`` (no lock
        held).  The caller — the group's owner — helps: it claims units
        until none remain, so progress never depends on a free worker.
        The first unit exception is re-raised (after all units settle),
        exactly like the serial ``[fn(x) for x in items]``."""
        items = list(items)
        if len(items) <= 1 or self.size <= 1:
            return [fn(x) for x in items]
        group = _TaskGroup(fn, items)
        with self._cv:
            self._groups.append(group)
            self._cv.notify_all()
        while True:  # owner helps
            with self._cv:
                i = group.claim()
            if i is None:
                break
            self._run_unit(group, i)
        with self._cv:
            while not group.finished:
                self._cv.wait(self._POLL_S)
            try:  # fully-claimed groups are usually popped lazily by
                self._groups.remove(group)  # _claim_unit; don't rely on it
            except ValueError:
                pass
        if group.error is not None:
            raise group.error
        return group.results

    # ------------------------------------------------------------------ #
    # caller-side synchronization
    # ------------------------------------------------------------------ #
    @property
    def busy(self) -> int:
        """Workers currently stepping a session or running a fan-out
        unit.  A point-in-time gauge for the metrics layer; the cv uses
        the service RLock, so reading under it from a metrics snapshot
        is re-entrant-safe."""
        return self._busy

    def check(self) -> None:
        """Raise if a worker thread crashed (call under the cv)."""
        if self._crash is not None:
            raise RuntimeError(
                "worker pool thread crashed — serving state is suspect"
            ) from self._crash

    def wait_idle(self) -> None:
        """Block until no admitted session remains (queued or checked
        out), the admission queue is empty, and every worker is idle."""
        with self._cv:
            while True:
                self.check()
                if (self._svc.scheduler.running == 0
                        and not self._svc._waiting
                        and not self._groups
                        and self._busy == 0):
                    return
                self._cv.wait(self._POLL_S)

    def shutdown(self) -> None:
        """Stop and join the workers.  In-flight steps complete (their
        checkin runs); nothing new is checked out afterwards."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)
