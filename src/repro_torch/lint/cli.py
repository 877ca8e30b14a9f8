"""``python -m repro_torch.lint [paths]`` — the command-line runner.

With no paths it lints the port, ``src/repro_torch`` and
``tests/test_torch_*.py`` of the checkout it is imported from.  Exit
status: 0 when clean, 1 when a finding survives its suppressions, 2 on
a usage error.  ``--report PATH`` also writes a JSON report (the files
checked, the findings and the rule table).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.lint.core import all_rules, iter_py_files, lint_file

ROOT = Path(__file__).resolve().parents[3]


def default_paths() -> List[Path]:
    """The port's package and its tests."""
    return [ROOT / "src" / "repro_torch",
            *sorted((ROOT / "tests").glob("test_torch_*.py"))]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="static analysis of the PyTorch/CUDA port")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: "
                        "src/repro_torch and tests/test_torch_*.py)")
    p.add_argument("--report", metavar="PATH", default=None,
                   help="write a JSON findings report to PATH")
    p.add_argument("--select", metavar="RULES", default=None,
                   help="comma-separated rule IDs/slugs to keep "
                        "(default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="print the summary line only")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    try:
        args = _parser().parse_args(argv)
    except SystemExit as e:            # argparse's usage error (or --help)
        return int(e.code or 0)
    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.slug:<20} {r.summary}")
        return 0

    selected = None
    if args.select:
        selected = {t.strip().lower() for t in args.select.split(",")
                    if t.strip()}
        known = {k.lower() for r in rules for k in (r.id, r.slug)}
        if selected - known:
            print(f"repro_torch.lint: unknown rules "
                  f"{sorted(selected - known)} (--list-rules)",
                  file=sys.stderr)
            return 2

    paths = args.paths or default_paths()
    files = iter_py_files(paths)
    if not files:
        print(f"repro_torch.lint: no .py files under "
              f"{[str(p) for p in paths]}", file=sys.stderr)
        return 2

    findings = []
    for f in files:
        found = lint_file(f)
        if selected is not None:
            found = [x for x in found
                     if {x.rule.id.lower(), x.rule.slug.lower()} & selected]
        findings.extend(found)

    if not args.quiet:
        for f in findings:
            print(f.format())
    if args.report:
        Path(args.report).write_text(json.dumps({
            "files_checked": len(files),
            "findings": [f.to_json() for f in findings],
            "rules": [{"id": r.id, "slug": r.slug, "summary": r.summary}
                      for r in rules]}, indent=2))
    n = len(findings)
    print(f"repro_torch.lint: {len(files)} files checked, {n} finding"
          f"{'' if n == 1 else 's'}")
    return 1 if findings else 0
