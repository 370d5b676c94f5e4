"""Static invariant lints + runtime sanitizers for the port's tree.

Two halves (docs/analysis_torch.md):

* **quiplint** (:mod:`repro_torch.analysis.lint`, ``python -m
  repro_torch.analysis``) — AST passes enforcing the conventions the
  serving stack's correctness rests on: env-discipline (every ``QUIPT_*``
  read goes through ``core.env`` against
  :data:`repro_torch.core.env.ENV_REGISTRY`), counter-discipline
  (``counters.<field> +=`` sites the provenance recorder mirrors),
  lock-discipline (``# guarded-by:`` annotations), span-discipline (tracer
  begin/end pairing), and kernel-triple parity (numpy/ref/CUDA + env knob
  per op).  Exit nonzero on findings.
* **lockcheck** (:mod:`repro_torch.analysis.lockcheck`) — the
  ``QUIPT_SANITIZE=locks`` runtime lock-order sanitizer; drop-in lock
  factories recording a global acquisition-order graph with cycle
  detection (potential-deadlock reports) plus contention telemetry.

This package stays import-light: lock sites across the tree import the
factories below at module import time, so nothing here may pull in the
executor/serving stack.
"""

from repro_torch.analysis.lockcheck import (
    LockOrderGraph,
    assert_acyclic,
    graph,
    make_condition,
    make_lock,
    make_rlock,
    report,
    reset,
    resolve_sanitize,
)

__all__ = [
    "LockOrderGraph",
    "assert_acyclic",
    "graph",
    "make_condition",
    "make_lock",
    "make_rlock",
    "report",
    "reset",
    "resolve_sanitize",
]
