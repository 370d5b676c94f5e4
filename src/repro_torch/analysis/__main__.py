"""``python -m repro_torch.analysis`` — run the port's quiplint over
``src/repro_torch``.

Exit status: 0 when the tree is clean, 1 when any pass found a violation
(the CI quiplint job gates on this).  ``--write-env-docs`` regenerates
the ``ENV_REGISTRY`` knob table in docs/analysis_torch.md in place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.analysis import lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="quiplint: invariant lint passes over the port's tree",
    )
    ap.add_argument("--root", default=None,
                    help="repository root (default: inferred from the "
                         "installed package location)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    ap.add_argument("--write-env-docs", action="store_true",
                    help="regenerate the ENV_REGISTRY table in "
                         "docs/analysis_torch.md and exit")
    args = ap.parse_args(argv)
    root = args.root or lint.find_repo_root()
    if args.write_env_docs:
        changed = lint.write_env_docs(root)
        print(f"{lint.DOCS_FILE}: table "
              + ("rewritten" if changed else "already in sync"))
        return 0
    findings = lint.lint_repo(root)
    if args.json:
        print(json.dumps([dataclasses.asdict(f) for f in findings],
                         indent=1))
    else:
        for f in findings:
            print(f)
        print(f"quiplint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
