"""Locale maintenance tool (for developers): scan the code for `i18n("...")`
call sites, sync the default-language file, and report drift per locale.

    python -m fish_speech_tpu_torch.i18n.scan [--root DIR ...] [--check]

Counterpart of `fish_speech_tpu/i18n/scan.py` (ref fish_speech/i18n/
scan.py: an AST walk for i18n() string arguments, the standard file
rewritten, the other locales diffed). With no --root it scans this
package. `--check` only reports (exit 1 on missing keys) without
rewriting files.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from collections import OrderedDict
from pathlib import Path

from .core import DEFAULT_LANGUAGE, I18N_FILE_PATH


def extract_i18n_strings(tree: ast.AST) -> list[str]:
    """All literal first-args of i18n(...) calls in an AST."""
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "i18n"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    found.append(arg.value)
    return found


def scan_roots(roots: list[Path]) -> list[str]:
    strings: list[str] = []
    for root in roots:
        for f in sorted(root.rglob("*.py")):
            code = f.read_text(encoding="utf-8")
            if "i18n(" not in code:
                continue
            hits = extract_i18n_strings(ast.parse(code))
            if hits:
                print(f"{f}: {len(hits)} i18n strings", file=sys.stderr)
            strings.extend(hits)
    return strings


def sync_locales(code_strings: list[str], *, check_only: bool = False,
                 locale_dir: Path = I18N_FILE_PATH) -> int:
    """Update the default-language file to exactly the code's key set and
    report unused/missing keys for every other locale. Returns the number of
    missing keys across locales (for --check exit status)."""
    code_keys = list(OrderedDict((s, None) for s in code_strings))
    standard_file = locale_dir / f"{DEFAULT_LANGUAGE}.json"
    standard = json.loads(standard_file.read_text(encoding="utf-8"))

    unused = set(standard) - set(code_keys)
    missing = set(code_keys) - set(standard)
    print(f"{standard_file.name}: {len(unused)} unused, "
          f"{len(missing)} missing", file=sys.stderr)
    total_missing = len(missing)

    if not check_only:
        new_standard = {k: standard.get(k, k) for k in sorted(code_keys)}
        standard_file.write_text(
            json.dumps(new_standard, ensure_ascii=False, indent=4,
                       sort_keys=True) + "\n", encoding="utf-8")

    for f in sorted(locale_dir.glob("*.json")):
        if f == standard_file:
            continue
        data = json.loads(f.read_text(encoding="utf-8"))
        loc_missing = set(code_keys) - set(data)
        loc_unused = set(data) - set(code_keys)
        print(f"{f.name}: {len(loc_unused)} unused, "
              f"{len(loc_missing)} missing", file=sys.stderr)
        for k in sorted(loc_missing):
            print(f"\tmissing: {k}", file=sys.stderr)
        total_missing += len(loc_missing)
    return total_missing


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", type=Path,
                    default=None, help="directories to scan (repeatable)")
    ap.add_argument("--check", action="store_true",
                    help="report only; exit 1 if any locale misses keys")
    args = ap.parse_args(argv)
    roots = args.root or [Path(__file__).resolve().parents[1]]
    strings = scan_roots(roots)
    print(f"total unique i18n strings: {len(set(strings))}", file=sys.stderr)
    missing = sync_locales(strings, check_only=args.check)
    return 1 if (args.check and missing) else 0


if __name__ == "__main__":
    raise SystemExit(main())
