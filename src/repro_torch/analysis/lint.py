"""quiplint for the port: AST invariant passes over ``src/repro_torch``
(docs/analysis_torch.md), the port of ``repro/analysis/lint.py``.

The serving stack's correctness rests on conventions no type checker sees:
every ``QUIPT_*`` env read goes through ``core.env``, every counter bump
names a real :class:`~repro_torch.core.stats.ExecutionCounters` field,
every mutation of a ``# guarded-by:`` attribute happens under its lock,
tracer ``begin``/``end`` spans pair up, and every public kernel op carries
the numpy/ref/cuda triple behind an env knob.  This module turns each
convention into a lint pass so drift fails CI instead of fuzz runs.

Run ``python -m repro_torch.analysis`` (exit nonzero on findings).  Passes
operate on a ``{relpath: source}`` mapping (``relpath`` relative to
``src/repro_torch``) so tests can feed synthetic fixtures;
:func:`lint_repo` additionally checks the generated ``ENV_REGISTRY``
table in docs/analysis_torch.md and that every registered knob is
exercised somewhere in ``src/repro_torch/`` or ``tests/``.

The passes are the reference's with the port's names: the ``QUIPT_*``
prefix and registry, the port's own parser and mutation whitelists, the
``"cuda"`` member where the reference has ``"pallas"``, an op's members
read from its knob's registered choices, and resolvers that name their
knob through a module-level helper (``kernels/ops.py`` ``_resolve``).

Annotation grammar (see docs/analysis_torch.md for the full catalog):

* ``# guarded-by: A|B`` — trailing comment on a ``self.X = ...``
  declaration in ``__init__``: every non-``__init__`` mutation of ``X``
  must run inside ``with <A or B>`` (terminal name of the with-item).
* ``# requires: A|B`` — on (or directly above) a ``def`` line: the method
  is a documented must-hold-caller contract; its body is checked as if
  A and B were held.
* ``# unguarded: <reason>`` — trailing waiver on one mutation line.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.env import ENV_REGISTRY

__all__ = [
    "Finding",
    "PASSES",
    "counters_pass",
    "docs_pass",
    "env_pass",
    "env_registry_table",
    "find_repo_root",
    "lint_repo",
    "lint_sources",
    "locks_pass",
    "parity_pass",
    "render_env_docs",
    "spans_pass",
    "usage_pass",
    "write_env_docs",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation: ``path:line: [pass] message``."""

    path: str
    line: int
    pass_name: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"


# --------------------------------------------------------------------------- #
# shared helpers
# --------------------------------------------------------------------------- #
_GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z0-9_|]*)")
_REQUIRES_RE = re.compile(r"requires:\s*([A-Za-z_][A-Za-z0-9_|]*)")
_UNGUARDED_RE = re.compile(r"unguarded:")
#: the prefix of the port's knobs (the reference's are ``QUIP_*``)
PREFIX = "QUIPT_"
_QUIP_RE = re.compile(r"^QUIPT_[A-Z0-9_]+$")

#: method names that mutate their receiver in place (the lock pass treats
#: ``self.attr.<mutator>(...)`` as a mutation of ``attr``)
MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "extendleft", "insert", "pop", "popitem", "popleft", "remove",
    "setdefault", "update",
})


def _comments_by_line(src: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # the AST pass reports the syntax error with a location
    return out


def _parse(path: str, src: str, pass_name: str,
           findings: List[Finding]) -> Optional[ast.Module]:
    try:
        return ast.parse(src)
    except SyntaxError as e:
        findings.append(Finding(path, e.lineno or 1, pass_name,
                                f"syntax error: {e.msg}"))
        return None


def _self_root_attr(node: ast.AST) -> Optional[str]:
    """First attribute hanging off ``self`` under any Subscript/Attribute
    chain: ``self.counters.imputations`` → ``counters``;
    ``self._owner[k][t]`` → ``_owner``; plain locals → None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


def _terminal_name(expr: ast.AST) -> Optional[str]:
    """Terminal name of a with-item / receiver: strip one Call, then the
    final attribute — ``self.store.flush_lock(t, a)`` → ``flush_lock``."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _flat_targets(targets: Sequence[ast.AST]) -> List[ast.AST]:
    out: List[ast.AST] = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_flat_targets(t.elts))
        else:
            out.append(t)
    return out


def _parent_map(tree: ast.AST) -> Dict[int, ast.AST]:
    return {id(child): parent
            for parent in ast.walk(tree)
            for child in ast.iter_child_nodes(parent)}


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# --------------------------------------------------------------------------- #
# pass 1: env-discipline
# --------------------------------------------------------------------------- #
#: files allowed to touch os.environ for QUIPT_* keys (the parsers)
ENV_PARSER_FILES = frozenset({"core/env.py"})
#: files allowed to *mutate* os.environ: none of the port's does (the
#: reference's are its import-time XLA launch shims, which the port lacks)
ENV_MUTATION_FILES: frozenset = frozenset()
_ENV_PARSERS = frozenset({"env_flag", "env_choice", "env_int"})
_ENVIRON_MUTATORS = frozenset({"setdefault", "pop", "update", "clear"})


def _is_os_environ(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def env_pass(sources: Dict[str, str]) -> List[Finding]:
    """``QUIPT_*`` env reads only via ``core.env``; ``os.environ`` mutation
    only in the whitelisted files (none); every knob literal registered in
    ``ENV_REGISTRY``."""
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        tree = _parse(path, src, "env-discipline", findings)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Subscript) and _is_os_environ(node.value):
                key = _const_str(node.slice)
                if (isinstance(node.ctx, (ast.Store, ast.Del))
                        and path not in ENV_MUTATION_FILES):
                    findings.append(Finding(
                        path, node.lineno, "env-discipline",
                        f"os.environ mutation of {key or '<dynamic>'!s} "
                        f"outside the whitelisted files",
                    ))
                elif (isinstance(node.ctx, ast.Load) and key
                        and key.startswith(PREFIX)
                        and path not in ENV_PARSER_FILES):
                    findings.append(Finding(
                        path, node.lineno, "env-discipline",
                        f"direct os.environ read of {key} — use the "
                        f"core.env parsers (env_flag/env_choice/env_int)",
                    ))
            elif isinstance(node, ast.Call):
                fname = _terminal_name(node.func)
                recv_env = (isinstance(node.func, ast.Attribute)
                            and _is_os_environ(node.func.value))
                args0 = _const_str(node.args[0]) if node.args else None
                if recv_env and fname in _ENVIRON_MUTATORS | {"get"}:
                    if (fname != "get" and path not in ENV_MUTATION_FILES):
                        findings.append(Finding(
                            path, node.lineno, "env-discipline",
                            f"os.environ.{fname}() outside the whitelisted "
                            f"files",
                        ))
                    elif (fname == "get" and args0
                          and args0.startswith(PREFIX)
                          and path not in ENV_PARSER_FILES):
                        findings.append(Finding(
                            path, node.lineno, "env-discipline",
                            f"direct os.environ.get of {args0} — use the "
                            f"core.env parsers",
                        ))
                elif (fname == "getenv" and args0
                      and args0.startswith(PREFIX)
                      and path not in ENV_PARSER_FILES):
                    findings.append(Finding(
                        path, node.lineno, "env-discipline",
                        f"os.getenv of {args0} — use the core.env parsers",
                    ))
                elif fname in _ENV_PARSERS and args0 is not None:
                    if args0 not in ENV_REGISTRY:
                        findings.append(Finding(
                            path, node.lineno, "env-discipline",
                            f"env knob {args0} is not in ENV_REGISTRY "
                            f"(core/env.py)",
                        ))
            elif isinstance(node, ast.Constant):
                val = node.value
                if (isinstance(val, str) and _QUIP_RE.fullmatch(val)
                        and val not in ENV_REGISTRY):
                    findings.append(Finding(
                        path, node.lineno, "env-discipline",
                        f"QUIPT_* literal {val} is not a registered knob",
                    ))
    return findings


# --------------------------------------------------------------------------- #
# pass 2: counter-discipline
# --------------------------------------------------------------------------- #
def _counter_fields() -> Set[str]:
    from repro_torch.core.stats import ExecutionCounters
    return {f.name for f in dataclasses.fields(ExecutionCounters)}


def _attr_chain(node: ast.AST) -> List[str]:
    """``self.counters.imputations`` → ["self", "counters", "imputations"]
    (subscripts transparent; non-name roots contribute nothing)."""
    parts: List[str] = []
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def counters_pass(sources: Dict[str, str]) -> List[Finding]:
    """Every ``counters.<field> += ...`` names a real ExecutionCounters
    field, and ``imputations`` only increments in a function that also
    calls ``provenance.on_flush`` — the reconciliation invariant the
    explain report is built on."""
    fields = _counter_fields()
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        tree = _parse(path, src, "counter-discipline", findings)
        if tree is None:
            continue
        parents = _parent_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.AugAssign):
                continue
            if not isinstance(node.target, ast.Attribute):
                continue
            chain = _attr_chain(node.target)
            if "counters" not in chain[:-1]:
                continue
            field = node.target.attr
            if field not in fields:
                findings.append(Finding(
                    path, node.lineno, "counter-discipline",
                    f"counters.{field} is not an ExecutionCounters field",
                ))
                continue
            if field == "imputations":
                fn = parents.get(id(node))
                while fn is not None and not isinstance(
                        fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = parents.get(id(fn))
                mirrored = fn is not None and any(
                    isinstance(c, ast.Call)
                    and _terminal_name(c.func) == "on_flush"
                    for c in ast.walk(fn)
                )
                if not mirrored:
                    findings.append(Finding(
                        path, node.lineno, "counter-discipline",
                        "counters.imputations increments without a "
                        "provenance.on_flush mirror in the same function",
                    ))
    return findings


# --------------------------------------------------------------------------- #
# pass 3: lock-discipline
# --------------------------------------------------------------------------- #
def _requires_for(fn: ast.FunctionDef, comments: Dict[int, str]) -> Set[str]:
    first_body = fn.body[0].lineno if fn.body else fn.lineno + 1
    req: Set[str] = set()
    for ln in range(fn.lineno - 1, first_body):
        m = _REQUIRES_RE.search(comments.get(ln, ""))
        if m:
            req |= set(m.group(1).split("|"))
    return req


def _guards_for(cls: ast.ClassDef, comments: Dict[int, str]
                ) -> Dict[str, Set[str]]:
    guards: Dict[str, Set[str]] = {}
    init = next((f for f in cls.body
                 if isinstance(f, ast.FunctionDef) and f.name == "__init__"),
                None)
    if init is None:
        return guards
    for node in ast.walk(init):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        m = _GUARDED_RE.search(comments.get(node.lineno, ""))
        if not m:
            continue
        alts = set(m.group(1).split("|"))
        for t in _flat_targets(targets):
            attr = _self_root_attr(t)
            if attr is not None:
                guards[attr] = alts
    return guards


def _scan_locked(node: ast.AST, held: Set[str], guards: Dict[str, Set[str]],
                 comments: Dict[int, str], path: str,
                 findings: List[Finding]) -> None:
    if isinstance(node, ast.With):
        names = {n for n in (_terminal_name(i.context_expr)
                             for i in node.items) if n}
        for item in node.items:
            _scan_locked(item, held, guards, comments, path, findings)
        inner = held | names
        for stmt in node.body:
            _scan_locked(stmt, inner, guards, comments, path, findings)
        return

    def flag(attr: str, lineno: int) -> None:
        if held & guards[attr]:
            return
        if _UNGUARDED_RE.search(comments.get(lineno, "")):
            return
        want = "|".join(sorted(guards[attr]))
        findings.append(Finding(
            path, lineno, "lock-discipline",
            f"mutation of {attr} (guarded-by: {want}) outside its lock "
            f"(held: {sorted(held) or 'none'}); wrap in `with`, add a "
            f"`# requires:` contract, or waive with `# unguarded: <why>`",
        ))

    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in _flat_targets(targets):
            attr = _self_root_attr(t)
            if attr in guards:
                flag(attr, node.lineno)
    elif isinstance(node, ast.Delete):
        for t in _flat_targets(node.targets):
            attr = _self_root_attr(t)
            if attr in guards:
                flag(attr, node.lineno)
    elif isinstance(node, ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in MUTATORS):
            attr = _self_root_attr(node.func.value)
            if attr in guards:
                flag(attr, node.lineno)
    for child in ast.iter_child_nodes(node):
        _scan_locked(child, held, guards, comments, path, findings)


def locks_pass(sources: Dict[str, str]) -> List[Finding]:
    """Every mutation of a ``# guarded-by:`` attribute runs under one of
    its locks (lexically: a ``with`` whose item's terminal name matches),
    under a ``# requires:`` method contract, or carries an explicit
    ``# unguarded:`` waiver.  ``__init__`` (construction) is exempt."""
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        tree = _parse(path, src, "lock-discipline", findings)
        if tree is None:
            continue
        comments = _comments_by_line(src)
        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            guards = _guards_for(cls, comments)
            if not guards:
                continue
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__":
                    continue
                held = _requires_for(fn, comments)
                for stmt in fn.body:
                    _scan_locked(stmt, held, guards, comments, path,
                                 findings)
    return findings


# --------------------------------------------------------------------------- #
# pass 4: span-discipline
# --------------------------------------------------------------------------- #
def _tracerish(expr: ast.AST) -> bool:
    name = _terminal_name(expr)
    return name is not None and name.lower().endswith("tracer")


def _with_names(fn: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                if isinstance(item.context_expr, ast.Name):
                    names.add(item.context_expr.id)
    return names


def spans_pass(sources: Dict[str, str]) -> List[Finding]:
    """Tracer spans close: every ``tracer.span(...)`` is used as a context
    manager (directly, or assigned to a name later entered with ``with``);
    ``tracer.begin(...)`` results are consumed (an unpaired begin leaks an
    open span) and a module that begins spans also ends them."""
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        tree = _parse(path, src, "span-discipline", findings)
        if tree is None:
            continue
        parents = _parent_map(tree)
        has_begin: Optional[ast.Call] = None
        has_end = False
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            if not _tracerish(node.func.value):
                continue
            meth = node.func.attr
            if meth == "end":
                has_end = True
            elif meth == "begin":
                if has_begin is None:
                    has_begin = node
                parent = parents.get(id(node))
                if isinstance(parent, ast.Expr):
                    findings.append(Finding(
                        path, node.lineno, "span-discipline",
                        "tracer.begin() result discarded — no id to "
                        "tracer.end() with; the span never closes",
                    ))
            elif meth == "span":
                cur: Optional[ast.AST] = node
                ok = False
                fn: Optional[ast.AST] = None
                while cur is not None:
                    parent = parents.get(id(cur))
                    if isinstance(parent, ast.withitem):
                        ok = True
                        break
                    if isinstance(parent, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.Module)):
                        fn = parent
                        break
                    if isinstance(parent, (ast.Assign, ast.AnnAssign)):
                        # find the function, then check the assigned name
                        # is entered via `with` somewhere in it
                        targets = (parent.targets
                                   if isinstance(parent, ast.Assign)
                                   else [parent.target])
                        names = {t.id for t in _flat_targets(targets)
                                 if isinstance(t, ast.Name)}
                        scope: Optional[ast.AST] = parent
                        while scope is not None and not isinstance(
                                scope, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Module)):
                            scope = parents.get(id(scope))
                        if scope is not None and names & _with_names(scope):
                            ok = True
                        break
                    if isinstance(parent, ast.Return):
                        ok = True  # caller owns the context entry
                        break
                    cur = parent
                if not ok:
                    findings.append(Finding(
                        path, node.lineno, "span-discipline",
                        "tracer.span(...) not entered as a context "
                        "manager — the span would never close",
                    ))
        if has_begin is not None and not has_end:
            findings.append(Finding(
                path, has_begin.lineno, "span-discipline",
                "module calls tracer.begin() but never tracer.end()",
            ))
    return findings


# --------------------------------------------------------------------------- #
# pass 5: kernel-triple parity
# --------------------------------------------------------------------------- #
#: the members of an op whose knob registers no choices: the reference's
#: numpy/ref/pallas triple, with the port's ``cuda`` for ``pallas``
TRIPLE = ("numpy", "ref", "cuda")


def _calls_env_choice(fn: ast.FunctionDef) -> bool:
    return any(isinstance(n, ast.Call)
               and _terminal_name(n.func) == "env_choice"
               for n in ast.walk(fn))


def _resolver_knob(fn: ast.FunctionDef, helpers: Set[str]) -> Optional[str]:
    """The ``QUIPT_*`` literal ``fn`` passes to ``env_choice``, or to a
    module-level helper that calls ``env_choice`` (``_resolve(knob, ...)``
    in the port's ``kernels/ops.py``); None when it passes none, and then
    ``fn`` is no resolver."""
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        name = _terminal_name(node.func)
        if name == "env_choice":
            args = node.args[:1]
        elif isinstance(node.func, ast.Name) and name in helpers:
            args = node.args
        else:
            continue
        for a in args:
            knob = _const_str(a)
            if knob is not None and knob.startswith(PREFIX):
                return knob
    return None


def _str_consts(fn: ast.AST) -> Set[str]:
    return {n.value for n in ast.walk(fn)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _named(fn: ast.FunctionDef, private: Dict[str, ast.FunctionDef]
           ) -> Set[str]:
    """The strings ``fn`` names, and those of the module-level private
    functions it hands ``impl`` to (``neighbor_aggregate`` takes its
    ``ref`` and ``cuda`` paths in ``_neighbor_aggregate_torch``)."""
    named = _str_consts(fn)
    for n in ast.walk(fn):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in private
                and any(isinstance(a, ast.Name) and a.id == "impl"
                        for a in n.args + [kw.value for kw in n.keywords])):
            named |= _str_consts(private[n.func.id])
    return named


def _members(knob: str) -> Sequence[str]:
    """The members an op resolved through ``knob`` carries: the choices the
    knob registers in ``ENV_REGISTRY``, else the triple."""
    entry = ENV_REGISTRY.get(knob)
    return entry.choices if entry is not None and entry.choices else TRIPLE


def parity_pass(sources: Dict[str, str]) -> List[Finding]:
    """Every public op in ``kernels/ops.py`` (``__all__``) resolves its
    ``impl`` through an env-knobbed ``resolve_*`` or forwards ``impl=impl``
    to a public op that does.  One that resolves carries every member its
    knob registers (``ref`` and ``cuda`` for ``QUIPT_ATTN_IMPL``; the
    numpy/ref/cuda triple where the knob registers no choices): it names
    each, except ``ref``, the path it takes when no named member matches
    (the reference's rule, which names ``numpy`` and ``pallas``), in its
    body or in a private function it hands ``impl`` to.  An op
    that forwards is held by the op it forwards to, even where it also
    resolves (``masked_knn`` takes its ``cuda`` path itself).  The
    resolvers themselves are not ops."""
    findings: List[Finding] = []
    for path, src in sorted(sources.items()):
        if not path.endswith("kernels/ops.py"):
            continue
        tree = _parse(path, src, "kernel-parity", findings)
        if tree is None:
            continue
        exported: Set[str] = set()
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                exported = {s for s in (
                    _const_str(e) for e in node.value.elts) if s}
        fns = {f.name: f for f in tree.body
               if isinstance(f, ast.FunctionDef)}
        helpers = {name for name, f in fns.items() if _calls_env_choice(f)}
        resolvers: Dict[str, str] = {}
        for fname, f in fns.items():
            knob = _resolver_knob(f, helpers)
            if knob is not None:
                resolvers[fname] = knob
        private = {fname: f for fname, f in fns.items()
                   if fname.startswith("_") and fname not in helpers}
        for name in sorted(exported):
            fn = fns.get(name)
            if fn is None or name in resolvers:
                continue
            all_args = fn.args.args + fn.args.kwonlyargs
            if not any(a.arg == "impl" for a in all_args):
                continue  # impl-less exports (e.g. resolve_device) are free
            knobs = [resolvers[n.func.id] for n in ast.walk(fn)
                     if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Name)
                     and n.func.id in resolvers]
            forwards = any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in exported and n.func.id != name
                and any(kw.arg == "impl"
                        and isinstance(kw.value, ast.Name)
                        and kw.value.id == "impl"
                        for kw in n.keywords)
                for n in ast.walk(fn)
            )
            if not knobs and not forwards:
                findings.append(Finding(
                    path, fn.lineno, "kernel-parity",
                    f"op {name} neither resolves impl via an env-knobbed "
                    f"resolve_* nor forwards impl= to a public op",
                ))
                continue
            if knobs and not forwards:
                consts = _named(fn, private)
                members = list(dict.fromkeys(
                    m for knob in knobs for m in _members(knob)))
                for required in members:
                    if required != "ref" and required not in consts:
                        findings.append(Finding(
                            path, fn.lineno, "kernel-parity",
                            f"op {name} has no {required!r} path — the "
                            f"{'/'.join(members)} members are incomplete",
                        ))
    return findings


# --------------------------------------------------------------------------- #
# repo-level passes: docs sync + registry usage
# --------------------------------------------------------------------------- #
DOCS_BEGIN = "<!-- ENV_REGISTRY:begin -->"
DOCS_END = "<!-- ENV_REGISTRY:end -->"
DOCS_FILE = os.path.join("docs", "analysis_torch.md")
#: the package the source passes walk, under ``<root>/src``
PACKAGE = "repro_torch"


def env_registry_table() -> str:
    """The knob table generated from ``ENV_REGISTRY`` — the docs between
    the markers in docs/analysis_torch.md must equal this exactly."""
    lines = [
        "| knob | kind | default | owner | doc |",
        "| --- | --- | --- | --- | --- |",
    ]
    for name in sorted(ENV_REGISTRY):
        k = ENV_REGISTRY[name]
        kind = k.kind
        if k.choices:
            kind += " (" + " \\| ".join(k.choices) + ")"
        lines.append(
            f"| `{name}` | {kind} | {k.default} | {k.owner} | {k.doc} |"
        )
    return "\n".join(lines)


def render_env_docs(text: str) -> Optional[str]:
    """``text`` with the generated table spliced between the markers;
    None when a marker is missing."""
    try:
        head, rest = text.split(DOCS_BEGIN, 1)
        _stale, tail = rest.split(DOCS_END, 1)
    except ValueError:
        return None
    return head + DOCS_BEGIN + "\n" + env_registry_table() + "\n" \
        + DOCS_END + tail


def docs_pass(root: str) -> List[Finding]:
    path = os.path.join(root, DOCS_FILE)
    if not os.path.exists(path):
        return [Finding(DOCS_FILE, 1, "docs-sync",
                        f"{DOCS_FILE} is missing")]
    with open(path) as fh:
        text = fh.read()
    rendered = render_env_docs(text)
    if rendered is None:
        return [Finding(DOCS_FILE, 1, "docs-sync",
                        f"missing {DOCS_BEGIN} / {DOCS_END} markers")]
    if rendered != text:
        line = text[:text.index(DOCS_BEGIN)].count("\n") + 1
        return [Finding(DOCS_FILE, line, "docs-sync",
                        "ENV_REGISTRY table is stale — run "
                        "`python -m repro_torch.analysis --write-env-docs`")]
    return []


def write_env_docs(root: str) -> bool:
    """Rewrite the generated table in docs/analysis_torch.md; True if
    changed."""
    path = os.path.join(root, DOCS_FILE)
    with open(path) as fh:
        text = fh.read()
    rendered = render_env_docs(text)
    if rendered is None:
        raise RuntimeError(f"{DOCS_FILE} lacks the ENV_REGISTRY markers")
    if rendered == text:
        return False
    with open(path, "w") as fh:
        fh.write(rendered)
    return True


def usage_pass(root: str, sources: Dict[str, str]) -> List[Finding]:
    """Every registered knob appears as a literal somewhere in
    src/repro_torch/ or tests/ — an unused registry entry is doc rot
    waiting to mislead."""
    # the registry entry itself (core/env.py) doesn't count as usage
    corpora = [src for path, src in sources.items() if path != "core/env.py"]
    tests_dir = os.path.join(root, "tests")
    if os.path.isdir(tests_dir):
        for name in sorted(os.listdir(tests_dir)):
            if name.endswith(".py"):
                with open(os.path.join(tests_dir, name)) as fh:
                    corpora.append(fh.read())
    env_src = sources.get("core/env.py", "")
    findings: List[Finding] = []
    for knob in sorted(ENV_REGISTRY):
        quoted = f'"{knob}"'
        if not any(quoted in text for text in corpora):
            line = next(
                (i + 1 for i, ln in enumerate(env_src.splitlines())
                 if quoted in ln), 1,
            )
            findings.append(Finding(
                "core/env.py", line, "registry-usage",
                f"registered knob {knob} is never read in src/repro_torch/ "
                f"or tests/",
            ))
    return findings


# --------------------------------------------------------------------------- #
# drivers
# --------------------------------------------------------------------------- #
#: the source-level passes, by name (tests index this)
PASSES: Dict[str, Callable[[Dict[str, str]], List[Finding]]] = {
    "env-discipline": env_pass,
    "counter-discipline": counters_pass,
    "lock-discipline": locks_pass,
    "span-discipline": spans_pass,
    "kernel-parity": parity_pass,
}


def lint_sources(sources: Dict[str, str]) -> List[Finding]:
    """Run every source-level pass over ``{relpath: source}``."""
    findings: List[Finding] = []
    for fn in PASSES.values():
        findings.extend(fn(sources))
    findings.sort(key=lambda f: (f.path, f.line, f.pass_name))
    return findings


def find_repo_root() -> str:
    """<root>/src/repro_torch/analysis/lint.py → <root>."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def load_sources(root: str) -> Dict[str, str]:
    """All of ``src/repro_torch`` as ``{relpath-from-src/repro_torch:
    source}``."""
    pkg = os.path.join(root, "src", PACKAGE)
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, pkg).replace(os.sep, "/")
            with open(full) as fh:
                out[rel] = fh.read()
    return out


def lint_repo(root: Optional[str] = None) -> List[Finding]:
    """The full quiplint run: source passes over ``src/repro_torch`` plus
    the docs-sync and registry-usage repo passes."""
    root = root or find_repo_root()
    sources = load_sources(root)
    findings = lint_sources(sources)
    findings.extend(docs_pass(root))
    findings.extend(usage_pass(root, sources))
    return findings
