"""Runtime lock-order sanitizer for the engine's locks.

Every lock of the port is created through :func:`make_lock` with a stable
name ("BloomFilter._lock", "ImputeStore.key", ...).  With
``QUIPT_SANITIZE`` unset (or ``off``) the factories return plain
``threading`` primitives — zero overhead, byte-identical behaviour.
Under ``QUIPT_SANITIZE=locks`` they return instrumented wrappers that
record, into one process-global :class:`LockOrderGraph`:

* **acquisition-order edges** — whenever a thread acquires lock B while
  holding lock A, the edge A→B is recorded with the acquiring stack the
  first time it is seen.  A cycle in this graph (A→B somewhere, B→A
  somewhere else) is a *potential deadlock* even if the fuzzer's
  interleavings never tripped it — that is the whole point: the graph
  turns "we happened not to deadlock" into "no acquisition-order cycle
  exists over everything the tests executed";
* **potential-deadlock reports** — detected online: the acquire that
  closes a cycle records the full cycle with the first-observed stack of
  every edge on it (both sides of an AB/BA inversion included);
* **contention telemetry** — per lock: acquisitions, contended acquires
  (the uncontended fast path is a single try-lock), and
  *held-while-blocking* events (blocking on this lock while holding at
  least one other — the shape every real deadlock is made of).

The reference package also has RLock and Condition factories for its
serving stack; they return with the port of that stack.
:func:`assert_acyclic` writes the JSON report to
``build/lock_sanitizer_report.json`` on failure.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

from repro_torch.core.env import env_choice

__all__ = [
    "SANITIZE_MODES",
    "LockOrderGraph",
    "assert_acyclic",
    "graph",
    "make_lock",
    "report",
    "reset",
    "resolve_sanitize",
]

SANITIZE_MODES = ("off", "locks")

#: default artifact path for assert_acyclic failures
REPORT_PATH = os.path.join("build", "lock_sanitizer_report.json")

_STACK_LIMIT = 16  # frames captured per first-observed edge


def resolve_sanitize() -> str:
    """``QUIPT_SANITIZE`` (``off`` | ``locks``, via :func:`env_choice`;
    garbage raises) — read at lock *construction* time, so a service built
    under the sanitizer stays sanitized for its lifetime."""
    return env_choice("QUIPT_SANITIZE", SANITIZE_MODES, "off")


class LockOrderGraph:
    """Process-global acquisition-order graph + contention telemetry.

    Nodes are lock *names* (several instances may share one — e.g. every
    per-(table, attr) flush lock is "ImputeStore.key"), edges are
    first-observed held→acquired pairs with captured stacks.  All methods
    are called from the lock wrappers; the graph's own mutex is a raw
    ``threading.Lock`` (never wrapped — it must not observe itself)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (src, dst) -> {count, thread, stack (first observation)}
        self._edges: Dict[Tuple[str, str], Dict] = {}
        # name -> {acquisitions, contended, held_while_blocking}
        self._nodes: Dict[str, Dict] = {}
        self._deadlocks: List[Dict] = []

    # -- per-thread held set ----------------------------------------------#
    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _node(self, name: str) -> Dict:
        node = self._nodes.get(name)
        if node is None:
            node = self._nodes[name] = {
                "acquisitions": 0, "contended": 0, "held_while_blocking": 0,
            }
        return node

    # -- wrapper hooks -----------------------------------------------------#
    def note_blocking(self, name: str) -> None:
        """About to block on ``name`` (the try-lock fast path failed)."""
        holding = len(self._held()) > 0
        with self._mu:
            node = self._node(name)
            node["contended"] += 1
            if holding:
                node["held_while_blocking"] += 1

    def note_acquired(self, name: str, contended: bool = False) -> None:
        """``name`` acquired by this thread; record held→name edges."""
        held = self._held()
        stack: Optional[List[str]] = None
        with self._mu:
            node = self._node(name)
            node["acquisitions"] += 1
            # (contended acquires were counted in note_blocking, pre-block)
            for src in dict.fromkeys(held):  # unique, insertion order
                if src == name:
                    continue  # same-name instances (key locks) — no edge
                key = (src, name)
                edge = self._edges.get(key)
                if edge is not None:
                    edge["count"] += 1
                    continue
                if stack is None:
                    stack = traceback.format_stack(limit=_STACK_LIMIT)[:-1]
                self._edges[key] = {
                    "src": src, "dst": name, "count": 1,
                    "thread": threading.current_thread().name,
                    "stack": stack,
                }
                cycle = self._path(name, src)
                if cycle is not None:
                    # path name→…→src already existed; this new src→name
                    # edge closes it.  Keep every on-cycle edge's
                    # first-observed stack (both sides of an AB/BA
                    # inversion included).
                    edge_keys = [(cycle[i], cycle[i + 1])
                                 for i in range(len(cycle) - 1)]
                    edge_keys.append(key)
                    self._deadlocks.append({
                        "cycle": cycle + [name],
                        "edges": [dict(self._edges[k]) for k in edge_keys
                                  if k in self._edges],
                    })
        held.append(name)

    def note_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- graph queries -----------------------------------------------------#
    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """Node path src→…→dst over recorded edges (call under _mu);
        None if unreachable."""
        if src == dst:
            return [src]
        adj: Dict[str, List[str]] = {}
        for (a, b) in self._edges:
            adj.setdefault(a, []).append(b)
        prev: Dict[str, str] = {}
        frontier = [src]
        seen = {src}
        while frontier:
            nxt = []
            for node in frontier:
                for child in adj.get(node, ()):
                    if child in seen:
                        continue
                    seen.add(child)
                    prev[child] = node
                    if child == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(child)
            frontier = nxt
        return None

    def cycles(self) -> List[List[str]]:
        """Every recorded edge that closes a cycle, as the node cycle it
        closes (deduplicated by node set)."""
        out: List[List[str]] = []
        seen_sets = set()
        with self._mu:
            for (a, b) in list(self._edges):
                path = self._path(b, a)
                if path is None:
                    continue
                cyc = path + [b]
                key = frozenset(cyc)
                if key not in seen_sets:
                    seen_sets.add(key)
                    out.append(cyc)
        return out

    def report(self) -> Dict:
        cycles = self.cycles()
        with self._mu:
            return {
                "mode": "locks",
                "locks": {k: dict(v) for k, v in sorted(self._nodes.items())},
                "edges": [dict(e) for e in self._edges.values()],
                "cycles": cycles,
                "potential_deadlocks": [dict(d) for d in self._deadlocks],
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._nodes.clear()
            self._deadlocks.clear()
        self._tls = threading.local()


_GRAPH = LockOrderGraph()


def graph() -> LockOrderGraph:
    return _GRAPH


def report() -> Dict:
    return _GRAPH.report()


def reset() -> None:
    _GRAPH.reset()


def assert_acyclic(artifact_path: Optional[str] = REPORT_PATH) -> Dict:
    """Raise ``AssertionError`` if the recorded acquisition-order graph
    has a cycle (a potential deadlock), writing the full JSON report to
    ``artifact_path`` first so CI can upload it.  Returns the report."""
    rep = _GRAPH.report()
    if rep["cycles"] or rep["potential_deadlocks"]:
        if artifact_path is not None:
            os.makedirs(os.path.dirname(artifact_path) or ".", exist_ok=True)
            with open(artifact_path, "w") as fh:
                json.dump(rep, fh, indent=1)
        names = " ; ".join("->".join(c) for c in rep["cycles"]) or \
            " ; ".join("->".join(d["cycle"])
                       for d in rep["potential_deadlocks"])
        raise AssertionError(
            f"lock-order cycle detected (potential deadlock): {names}"
            + (f" — report written to {artifact_path}"
               if artifact_path is not None else "")
        )
    return rep


# --------------------------------------------------------------------------- #
# instrumented wrappers
# --------------------------------------------------------------------------- #
class _SanLock:
    """Drop-in ``threading.Lock`` feeding the lock-order graph.

    The uncontended path is one extra try-lock plus the held-set/edge
    bookkeeping; the contended path records contention (and
    held-while-blocking) *before* blocking, so a real deadlock still
    leaves its telemetry behind."""

    __slots__ = ("_name", "_graph", "_lock")

    def __init__(self, name: str, g: LockOrderGraph):
        self._name = name
        self._graph = g
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        contended = not self._lock.acquire(False)
        if contended:
            self._graph.note_blocking(self._name)
            if not blocking:
                return False
            if not self._lock.acquire(True, timeout):
                return False
        self._graph.note_acquired(self._name, contended)
        return True

    def release(self) -> None:
        self._graph.note_released(self._name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "_SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return f"<SanLock {self._name} {self._lock!r}>"


# --------------------------------------------------------------------------- #
# factories — the only API lock sites use
# --------------------------------------------------------------------------- #
def make_lock(name: str):
    """A ``threading.Lock`` (or its sanitized wrapper under
    ``QUIPT_SANITIZE=locks``) registered under ``name`` in the lock-order
    graph.  Instances may share a name (the per-(table, attr) flush locks
    all report as "ImputeStore.key")."""
    if resolve_sanitize() == "locks":
        return _SanLock(name, _GRAPH)
    return threading.Lock()
