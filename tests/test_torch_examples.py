"""The port's two QUIP examples against the reference's, on the CPU.

``examples/quickstart_torch.py`` (the paper's example, its own copy of
Tables 1-3 and of the oracle imputer) and ``examples/quip_sql_demo_torch.py``
(the wifi KNN workload in miniature) run with ``--device cpu``; every line
they print must equal the reference example's, but for the measured
runtimes.  Both run in this process under ``frozen_clocks``, so that the
adaptive strategy decides from the imputers' simulated costs alone in
both packages.
"""

from __future__ import annotations

import ast
import contextlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest

from port_twin import frozen_clocks  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _printed(monkeypatch, script: str, *args: str) -> list:
    """The lines ``examples/<script>`` prints, each runtime blanked."""
    monkeypatch.setattr(sys, "argv", [script, *args])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(EXAMPLES / script), run_name="__main__")
    return [re.sub(r"runtime=\s*[0-9.]+ ms", "runtime=", line)
            for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "quip_sql_demo_torch.py"])
def test_port_example_imports_only_the_port(script):
    """Nothing of the reference or of JAX, nor of ``tests/``: the example
    runs where only ``repro_torch`` is installed."""
    tree = ast.parse((EXAMPLES / script).read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert "repro_torch" in roots
    assert not roots & {"repro", "jax", "paper_example", "port_twin"}


@pytest.mark.parametrize("reference, port", [
    ("quickstart.py", "quickstart_torch.py"),
    ("quip_sql_demo.py", "quip_sql_demo_torch.py"),
])
def test_example_prints_the_reference_answers(monkeypatch, frozen_clocks,
                                              reference, port):
    want = _printed(monkeypatch, reference)
    got = _printed(monkeypatch, port, "--device", "cpu")
    assert got == want
    # every strategy reported, with its imputation count
    strategies = [line.split(":")[0].strip() for line in got
                  if "imputations=" in line]
    assert sorted(strategies) == ["adaptive", "imputedb", "lazy", "offline"]


def test_quickstart_answers_the_paper(monkeypatch, frozen_clocks):
    """Paper Fig. 6-g's answer, with 3 imputations for the lazy and
    adaptive strategies against 9 offline (paper §1.2)."""
    lines = {line.split(":")[0].strip(): line
             for line in _printed(monkeypatch, "quickstart_torch.py",
                                  "--device", "cpu") if "answer=" in line}
    for strategy, imputations in (("lazy", 3), ("adaptive", 3),
                                  ("offline", 9)):
        assert "answer=[(2, 12, 2206)]" in lines[strategy]
        assert f"imputations={imputations}" in lines[strategy]
