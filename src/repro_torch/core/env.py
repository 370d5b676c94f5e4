"""Environment-variable parsing shared by every QUIPT_* gate of the port.

The port reads its own knobs, all named ``QUIPT_*``, and never a
``QUIP_*`` one: the reference package's resolvers reject values they do
not know (``cuda`` among them), so one shared ``QUIP_*_IMPL`` variable
could not serve both packages in one process.

:func:`env_flag` parses booleans (1/true/yes/on, 0/false/no/off),
:func:`env_choice` enumerated values and :func:`env_int` integers.  Unset
means the default; any other value raises instead of silently picking one.

:data:`ENV_REGISTRY` is the one catalog of every ``QUIPT_*`` knob the port
reads: name, kind, default, accepted values, owning module, one-line doc.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["ENV_REGISTRY", "EnvKnob", "env_flag", "env_choice", "env_int"]

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off"})


def env_flag(name: str, default: bool) -> bool:
    """Boolean env var ``name``: 1/true/yes/on ↔ 0/false/no/off (any case).

    Unset (or empty) returns ``default``; any other value raises
    ``ValueError`` — a typo'd gate must not silently mean "off".
    """
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(default)
    value = raw.strip().lower()
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    raise ValueError(
        f"{name}={raw!r} is not a boolean flag "
        f"(expected one of {sorted(_TRUE)} or {sorted(_FALSE)})"
    )


def env_choice(name: str, choices: Sequence[str], default: str) -> str:
    """Enumerated env var ``name``: one of ``choices`` (any case).

    Unset (or empty) returns ``default``; any other value raises
    ``ValueError`` — a typo'd impl name must not silently pick a default.
    """
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    value = raw.strip().lower()
    if value in choices:
        return value
    raise ValueError(
        f"{name}={raw!r} is not a valid choice (expected one of {sorted(choices)})"
    )


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Integer env var ``name`` (e.g. ``QUIPT_FUZZ_SEED``).

    Unset (or empty) returns ``default``; any non-integer value raises
    ``ValueError`` — a typo'd seed must not silently fall back to the
    default sweep.
    """
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return int(raw.strip())
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer"
        ) from None


# --------------------------------------------------------------------------- #
# the QUIPT_* knob registry
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One registered ``QUIPT_*`` environment knob.

    ``kind`` is the parser family (``flag`` | ``choice`` | ``int``);
    ``default`` is the human-readable unset behaviour; ``choices`` lists
    the accepted spellings for ``choice`` knobs; ``owner`` names the module
    whose resolver reads it."""

    name: str
    kind: str
    default: str
    doc: str
    choices: Tuple[str, ...] = ()
    owner: str = ""


def _registry(*knobs: EnvKnob) -> Dict[str, EnvKnob]:
    out: Dict[str, EnvKnob] = {}
    for knob in knobs:
        if knob.name in out:
            raise ValueError(f"duplicate ENV_REGISTRY knob {knob.name}")
        out[knob.name] = knob
    return out


#: Every QUIPT_* knob the port reads.
ENV_REGISTRY: Dict[str, EnvKnob] = _registry(
    EnvKnob("QUIPT_SHARED_IMPUTE", "flag", "off",
            "cross-query imputation sharing (one ImputeStore for all "
            "sessions)", owner="service/impute_store.py"),
    EnvKnob("QUIPT_IMPUTE_BATCH", "flag", "on",
            "batched request-queue imputation (off = per-call flushes)",
            owner="imputers/base.py"),
    EnvKnob("QUIPT_KNN_IMPL", "choice", "numpy",
            "KNN neighbour-aggregation dispatch (mean/mode): numpy host "
            "member, plain torch, or the CUDA kernels",
            choices=("numpy", "ref", "cuda"), owner="kernels/ops.py"),
    EnvKnob("QUIPT_JOIN_IMPL", "choice", "numpy (engine) / auto (kernel: "
            "cuda on a CUDA device, ref on the CPU)",
            "join-spine dispatch: numpy sort-join oracle, plain torch "
            "sort-join, or the CUDA hash-join kernels; unset means numpy in "
            "the engine (core/triggers.py) and the device default in "
            "kernels/ops.py hash_join_match",
            choices=("numpy", "ref", "cuda"), owner="core/triggers.py"),
    EnvKnob("QUIPT_BLOOM_IMPL", "choice", "auto (cuda on a CUDA tensor, "
            "ref on a CPU tensor)", "bloom-probe dispatch for join pruning",
            choices=("numpy", "ref", "cuda"), owner="kernels/ops.py"),
    EnvKnob("QUIPT_DIST_IMPL", "choice", "auto (cuda on a CUDA tensor, "
            "ref on a CPU tensor)", "masked KNN partial-distance dispatch",
            choices=("numpy", "ref", "cuda"), owner="kernels/ops.py"),
    EnvKnob("QUIPT_ATTN_IMPL", "choice", "auto (cuda on a CUDA tensor, "
            "ref on a CPU tensor)",
            "attention dispatch of the LM's attn_impl='cuda' path: the plain "
            "materialised softmax or the flash-attention kernel",
            choices=("ref", "cuda"), owner="kernels/ops.py"),
    EnvKnob("QUIPT_SEGMENT_IMPL", "choice", "numpy",
            "segment-reduction dispatch for the compiled executor's grouped "
            "aggregates: numpy host member, plain torch, or the CUDA kernels",
            choices=("numpy", "ref", "cuda"), owner="kernels/ops.py"),
    EnvKnob("QUIPT_EXEC_IMPL", "choice", "interp",
            "executor dispatch: the morsel interpreter, or compiled tensor "
            "plans where the strategy and knobs allow (else the interpreter, "
            "counted in compile_fallbacks)",
            choices=("interp", "compiled"), owner="core/compiled.py"),
    EnvKnob("QUIPT_TRACE", "flag", "off",
            "span tracing (Chrome-trace/Perfetto export)",
            owner="obs/trace.py"),
    EnvKnob("QUIPT_TRACE_CLOCK", "choice", "wall",
            "span-tracer clock: wall seconds or the deterministic unit "
            "tick", choices=("wall", "unit"), owner="obs/trace.py"),
    EnvKnob("QUIPT_EXPLAIN", "flag", "off",
            "per-query impute-provenance recording (explain reports)",
            owner="obs/provenance.py"),
    EnvKnob("QUIPT_IVM", "flag", "off",
            "delta-driven result-cache maintenance: patch cached answers "
            "under registry mutations instead of evicting them",
            owner="service/ivm.py"),
    EnvKnob("QUIPT_FUZZ_SEED", "int", "unset",
            "extra seed injected into the serving-fuzzer sweeps",
            owner="tests/test_torch_serving_fuzz.py"),
    EnvKnob("QUIPT_SANITIZE", "choice", "off",
            "runtime sanitizers: 'locks' swaps every lock site for "
            "instrumented wrappers feeding the lock-order graph",
            choices=("off", "locks"), owner="analysis/lockcheck.py"),
)
