"""The port's quiplint (``repro_torch.analysis``) against the reference's
(``repro.analysis``): the twin of the lint half of ``tests/test_analysis.py``.

* **mirrored fixtures** — each of the reference's synthetic fixtures, with
  ``QUIP_`` → ``QUIPT_`` and ``pallas`` → ``cuda``, gives the port's passes
  the same findings (path, line, pass) as the reference's passes give on
  the original;
* **the port's own rules** — the empty ``os.environ`` mutation whitelist,
  resolvers that name their knob through a helper, the ``ref`` member;
* **the real tree** — ``lint_repo()`` is clean on ``src/repro_torch`` and
  ``python -m repro_torch.analysis`` exits 0, and perturbing the real
  sources re-introduces findings;
* **docs** — the knob table of docs/analysis_torch.md round-trips.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

import test_analysis as reference_tests
from repro.analysis import lint as jax_lint
from repro_torch.analysis import lint
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.lint import PASSES, lint_repo, lint_sources
from repro_torch.core.env import ENV_REGISTRY

ROOT = lint.find_repo_root()


def _msgs(findings):
    return [str(f) for f in findings]


def _keys(findings):
    return sorted((f.path, f.line, f.pass_name) for f in findings)


def _mirror(src: str) -> str:
    return src.replace("QUIP_", "QUIPT_").replace("pallas", "cuda")


# the reference's fixtures (tests/test_analysis.py), by name: {path: source}
FIXTURES = {
    "env-direct-reads": {"service/x.py": (
        "import os\n"
        'a = os.environ["QUIP_TRACE"]\n'
        'b = os.environ.get("QUIP_TRACE")\n'
        'c = os.getenv("QUIP_TRACE")\n')},
    "env-mutation": {"service/x.py":
                     'import os\nos.environ["XLA_FLAGS"] = "x"\n'},
    "env-unregistered": {"core/x.py": (
        'from repro.core.env import env_flag\nv = env_flag("QUIP_NOPE")\n')},
    "env-registered": {"core/x.py": (
        'from repro.core.env import env_flag\nv = env_flag("QUIP_TRACE")\n')},
    "counters-unknown": {"core/x.py":
                         "def f(self):\n    self.counters.bogus_total += 1\n"},
    "counters-known": {"core/x.py":
                       "def f(self):\n    self.counters.join_tests += 1\n"},
    "counters-unmirrored": {"imputers/x.py":
                            "def f(self):\n"
                            "    self.counters.imputations += 3\n"},
    "counters-mirrored": {"imputers/x.py": (
        "def f(self):\n"
        "    self.counters.imputations += 3\n"
        "    self.provenance.on_flush(self, [], [], 0)\n")},
    "locks": {"service/x.py": reference_tests._LOCK_FIXTURE},
    "spans-bad": {"obs/x.py": (
        "def f(tracer):\n"
        '    tracer.span("x")\n'
        '    tracer.begin("y")\n')},
    "spans-ok": {"obs/x.py": (
        "def f(tracer):\n"
        '    with tracer.span("x"):\n'
        "        pass\n"
        '    sp = tracer.span("y")\n'
        "    with sp:\n"
        "        pass\n"
        '    tid = tracer.begin("z")\n'
        "    tracer.end(tid)\n"
        "def g(tracer):\n"
        '    return tracer.span("caller-owned")\n')},
    "parity": {"kernels/ops.py": reference_tests._OPS_FIXTURE},
    "parity-elsewhere": {"kernels/other.py": reference_tests._OPS_FIXTURE},
    "syntax-error": {"core/x.py": "def broken(:\n"},
    "everything": {
        "service/x.py": reference_tests._LOCK_FIXTURE,
        "kernels/ops.py": reference_tests._OPS_FIXTURE,
        "core/x.py": 'v = env_flag("QUIP_NOPE")\n',
    },
}


# --------------------------------------------------------------------------- #
# the reference's fixtures, mirrored
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_mirrored_fixture_gives_the_reference_findings(name):
    sources = FIXTURES[name]
    want = jax_lint.lint_sources(sources)
    got = lint_sources({p: _mirror(s) for p, s in sources.items()})
    assert _keys(got) == _keys(want), (_msgs(got), _msgs(want))


@pytest.mark.parametrize("pass_name", sorted(jax_lint.PASSES))
def test_each_pass_mirrors_the_reference(pass_name):
    """Pass by pass over every fixture at once."""
    sources = {f"{name}/{p}": s for name, fx in FIXTURES.items()
               for p, s in fx.items() if name != "everything"}
    # the parity pass reads kernels/ops.py by its path's ending
    want = jax_lint.PASSES[pass_name](sources)
    got = PASSES[pass_name]({p: _mirror(s) for p, s in sources.items()})
    assert _keys(got) == _keys(want)
    assert list(PASSES) == list(jax_lint.PASSES)


def test_mirrored_fixtures_flag_what_the_reference_flags():
    """The counts the reference's tests assert, on the mirrors."""
    env = PASSES["env-discipline"]
    f = env({"service/x.py": _mirror(FIXTURES["env-direct-reads"][
        "service/x.py"])})
    assert len(f) == 3 and all("QUIPT_TRACE" in x.message for x in f)
    f = PASSES["lock-discipline"]({"service/x.py":
                                   reference_tests._LOCK_FIXTURE})
    assert len(f) == 2 and all("guarded-by" in x.message for x in f)
    f = PASSES["span-discipline"](FIXTURES["spans-bad"])
    assert len(f) == 3
    f = PASSES["kernel-parity"]({"kernels/ops.py": _mirror(
        reference_tests._OPS_FIXTURE)})
    by_op = {x.message.split(" ")[1]: x.message for x in f}
    assert set(by_op) == {"op_half", "op_bare"}, _msgs(f)
    assert "'cuda'" in by_op["op_half"]
    assert "neither resolves" in by_op["op_bare"]


# --------------------------------------------------------------------------- #
# the port's own rules
# --------------------------------------------------------------------------- #
def test_no_file_may_mutate_the_environment():
    """The reference whitelists its XLA launch shims; the port has none, so
    a mutation is flagged wherever it is."""
    assert lint.ENV_MUTATION_FILES == frozenset()
    src = 'import os\nos.environ["XLA_FLAGS"] = "x"\n'
    for path in ("launch/dryrun.py", "core/env.py", "launch/train.py"):
        f = PASSES["env-discipline"]({path: src})
        assert len(f) == 1 and "mutation" in f[0].message
    f = PASSES["env-discipline"]({"core/x.py": "import os\nos.environ.pop('A')\n"})
    assert len(f) == 1


def test_env_pass_reads_the_ports_registry():
    assert all(k.startswith("QUIPT_") for k in ENV_REGISTRY)
    ok = 'v = env_choice("QUIPT_BLOOM_IMPL", ("numpy",), "numpy")\n'
    assert PASSES["env-discipline"]({"kernels/x.py": ok}) == []
    # an unregistered knob: flagged at the parser call and as a literal
    bad = 'v = env_flag("QUIPT_SHARED")\n'
    assert len(PASSES["env-discipline"]({"core/x.py": bad})) == 2
    # only the parsers' file reads os.environ directly
    direct = 'import os\nv = os.environ.get("QUIPT_TRACE")\n'
    assert PASSES["env-discipline"]({"core/env.py": direct}) == []
    assert len(PASSES["env-discipline"]({"core/y.py": direct})) == 1


_HELPER_OPS = '''
__all__ = ["op_helper", "op_no_cuda", "op_pair", "resolve_a_impl",
           "resolve_b_impl", "resolve_device"]
_IMPLS = ("numpy", "ref", "cuda")

def _resolve(knob, impl):
    return impl or env_choice(knob, _IMPLS, "numpy")

def resolve_a_impl(impl=None):
    return _resolve("QUIPT_TRACE", impl)

def resolve_b_impl(impl=None):
    return impl or env_choice("QUIPT_ATTN_IMPL", ("ref", "cuda"), "ref")

def resolve_device(device="cuda"):
    return device

def op_helper(x, impl=None):
    impl = resolve_a_impl(impl)
    if impl == "numpy":
        return x
    if impl == "cuda":
        return x
    return x

def op_no_cuda(x, impl=None):
    impl = resolve_a_impl(impl)
    if impl == "numpy":
        return x
    return x

def op_pair(x, impl=None):
    impl = resolve_b_impl(impl)
    if impl == "cuda":
        return x
    return x
'''


def _flagged(findings):
    return [(x.message.split(" ")[1], x.message.split(" ")[4])
            for x in findings]


def test_parity_pass_follows_a_resolver_helper():
    """``_resolve(knob, ...)`` makes ``resolve_a_impl`` a resolver (not an
    op): its knob registers no choices, so its ops carry the triple, and
    one that names no ``cuda`` path is flagged (``ref`` is the path an op
    takes when no named member matches)."""
    f = PASSES["kernel-parity"]({"kernels/ops.py": _HELPER_OPS})
    assert _flagged(f) == [("op_no_cuda", "'cuda'")], _msgs(f)
    # without the helper's knob literal nothing resolves, and the former
    # resolver is an op like the others
    bare = _HELPER_OPS.replace('_resolve("QUIPT_TRACE", impl)',
                               "_resolve(KNOB, impl)")
    f = PASSES["kernel-parity"]({"kernels/ops.py": bare})
    assert sorted(x.message.split(" ")[1] for x in f) == \
        ["op_helper", "op_no_cuda", "resolve_a_impl"]
    assert all("neither resolves" in x.message for x in f)


def test_parity_pass_requires_the_knobs_registered_members():
    """An op carries the members its knob registers in ``ENV_REGISTRY``:
    ``QUIPT_ATTN_IMPL`` takes ``ref`` or ``cuda``, so ``op_pair`` needs no
    numpy path; under a knob that registers all three it does."""
    assert ENV_REGISTRY["QUIPT_ATTN_IMPL"].choices == ("ref", "cuda")
    assert ENV_REGISTRY["QUIPT_BLOOM_IMPL"].choices == ("numpy", "ref", "cuda")
    triple = _HELPER_OPS.replace('"QUIPT_ATTN_IMPL"', '"QUIPT_BLOOM_IMPL"')
    f = PASSES["kernel-parity"]({"kernels/ops.py": triple})
    assert _flagged(f) == [("op_no_cuda", "'cuda'"), ("op_pair", "'numpy'")]
    assert "numpy/ref/cuda" in f[1].message


# --------------------------------------------------------------------------- #
# the real tree
# --------------------------------------------------------------------------- #
def test_repo_lint_is_clean():
    assert lint_repo() == []


def test_lint_walks_the_port():
    sources = lint.load_sources(ROOT)
    assert "kernels/ops.py" in sources and "analysis/lint.py" in sources
    assert "models/mamba.py" in sources
    assert not any(p.startswith("repro/") for p in sources)


def test_cli_exits_zero(capsys):
    assert lint_main([]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s)")
    assert lint_main(["--json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_python_m_exits_zero():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


def _real_sources():
    return lint.load_sources(ROOT)


def _perturb(sources, path, old, new):
    assert old in sources[path], f"perturbation anchor gone from {path}: {old!r}"
    sources[path] = sources[path].replace(old, new)
    return sources


def test_perturb_dropped_requires_contract_is_flagged():
    srcs = _perturb(_real_sources(), "imputers/base.py",
                    "# requires: flush_lock", "")
    f = [x for x in PASSES["lock-discipline"](srcs)
         if x.path == "imputers/base.py"]
    assert f and all("guarded-by" in x.message for x in f)


def test_perturb_renamed_lock_is_flagged():
    srcs = _perturb(_real_sources(), "obs/trace.py",
                    "with self._lock:", "with self._nolock:")
    f = [x for x in PASSES["lock-discipline"](srcs)
         if x.path == "obs/trace.py"]
    assert f, "tracer mutations outside the renamed lock were not flagged"


def test_perturb_orphaned_begin_is_flagged():
    srcs = _perturb(_real_sources(), "service/server.py",
                    "self.tracer.end(", "self.tracer.noop(")
    f = [x for x in PASSES["span-discipline"](srcs)
         if x.path == "service/server.py"]
    assert any("never tracer.end" in x.message for x in f)


def test_perturb_removed_waiver_is_flagged():
    srcs = _perturb(
        _real_sources(), "service/server.py",
        "  # unguarded: workers joined; no concurrent readers remain", "")
    f = [x for x in PASSES["lock-discipline"](srcs)
         if x.path == "service/server.py"]
    assert any("_pool" in x.message for x in f)


def test_perturb_unmirrored_imputations_is_flagged():
    srcs = _perturb(_real_sources(), "imputers/base.py",
                    "self.provenance.on_flush(", "self.provenance.noop(")
    f = [x for x in PASSES["counter-discipline"](srcs)
         if x.path == "imputers/base.py"]
    assert f and all("on_flush" in x.message for x in f)


def test_perturb_direct_env_read_is_flagged():
    srcs = _perturb(_real_sources(), "obs/trace.py",
                    "from __future__ import annotations",
                    "from __future__ import annotations\nimport os\n"
                    "_X = os.environ.get(\"QUIPT_TRACE\")")
    f = [x for x in PASSES["env-discipline"](srcs) if x.path == "obs/trace.py"]
    assert len(f) == 1 and "QUIPT_TRACE" in f[0].message


@pytest.mark.parametrize("op, old, member", [
    ("masked_distance",
     '    if impl == "cuda":\n        return _masked_distance_cuda(',
     "'cuda'"),
    ("masked_distance",
     '    if impl == "numpy":\n        return _masked_distance_numpy(',
     "'numpy'"),
    ("flash_attention",
     '    if impl == "cuda":\n        return _flash_attention_cuda(',
     "'cuda'"),
])
def test_perturb_dropped_member_is_flagged(op, old, member):
    """Dropping a named member's branch flags that member; the attention's
    knob registers ``ref`` and ``cuda`` only, so it needs no numpy path."""
    srcs = _perturb(_real_sources(), "kernels/ops.py", old,
                    "    if False:\n        return _drop(")
    f = PASSES["kernel-parity"](srcs)
    assert _flagged(f) == [(op, member)], _msgs(f)


def test_perturb_unknobbed_resolver_is_flagged():
    srcs = _perturb(_real_sources(), "kernels/ops.py",
                    'return _resolve("QUIPT_BLOOM_IMPL", "bloom", impl, device)',
                    'return _resolve(BLOOM_KNOB, "bloom", impl, device)')
    f = PASSES["kernel-parity"](srcs)
    assert sorted(x.message.split(" ")[1] for x in f) == \
        ["bloom_probe", "bloom_probe_keys", "resolve_bloom_impl"]
    assert all("neither resolves" in x.message for x in f)


def test_lint_sources_reports_syntax_errors():
    f = lint_sources({"core/x.py": "def broken(:\n"})
    assert f and all("syntax error" in x.message for x in f)


# --------------------------------------------------------------------------- #
# docs and registry usage
# --------------------------------------------------------------------------- #
def test_env_docs_render_roundtrip():
    text = ("head\n" + lint.DOCS_BEGIN + "\nstale\n" + lint.DOCS_END
            + "\ntail\n")
    rendered = lint.render_env_docs(text)
    assert lint.env_registry_table() in rendered
    assert lint.render_env_docs(rendered) == rendered  # idempotent
    assert lint.render_env_docs("no markers") is None
    assert all(f"`{k}`" in lint.env_registry_table() for k in ENV_REGISTRY)
    assert "QUIP_TRACE`" not in lint.env_registry_table()


def test_docs_file_is_the_ports_own(tmp_path):
    """The docs pass reads docs/analysis_torch.md (the reference's
    docs/analysis.md is not the port's); a stale table is flagged and
    ``--write-env-docs`` repairs it."""
    assert lint.DOCS_FILE == os.path.join("docs", "analysis_torch.md")
    assert lint.docs_pass(ROOT) == []
    (tmp_path / "docs").mkdir()
    assert lint.docs_pass(str(tmp_path))[0].message.endswith("is missing")
    text = open(os.path.join(ROOT, lint.DOCS_FILE)).read()
    stale = text.replace("| `QUIPT_IVM` |", "| `QUIPT_IVMX` |")
    (tmp_path / lint.DOCS_FILE).write_text(stale)
    f = lint.docs_pass(str(tmp_path))
    assert len(f) == 1 and "stale" in f[0].message
    assert lint_main(["--root", str(tmp_path), "--write-env-docs"]) == 0
    assert (tmp_path / lint.DOCS_FILE).read_text() == text
    assert lint.docs_pass(str(tmp_path)) == []


def test_usage_pass_looks_through_the_port_and_tests(tmp_path):
    """A knob literal counts in ``src/repro_torch`` or ``tests/``, never in
    the registry itself; a root whose tests are gone leaves only the knobs
    the port's sources read."""
    sources = _real_sources()
    assert lint.usage_pass(ROOT, sources) == []
    f = lint.usage_pass(str(tmp_path), {"core/env.py":
                                        sources["core/env.py"]})
    assert sorted(x.message.split(" ")[2] for x in f) == sorted(ENV_REGISTRY)
    os.makedirs(tmp_path / "tests")
    shutil.copy(os.path.join(ROOT, "tests", "test_torch_port.py"),
                tmp_path / "tests")
    left = lint.usage_pass(str(tmp_path), {"core/env.py":
                                           sources["core/env.py"]})
    assert len(left) < len(f)
