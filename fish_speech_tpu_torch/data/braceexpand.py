"""Minimal bash-style brace expansion for dataset path lists.

Counterpart of `fish_speech_tpu/data/braceexpand.py`. Covers the patterns
the reference corpus configs use (ref fish_speech/utils/braceexpand.py):
comma lists `{a,b,c}`, numeric ranges `{0..9}` (with zero-padding
`{00..99}`), and nesting. Unmatched braces pass through unchanged.
"""

from __future__ import annotations

import re
from typing import Iterator

_RANGE_RE = re.compile(r"^(-?\d+)\.\.(-?\d+)(?:\.\.(-?\d+))?$")


def braceexpand(pattern: str) -> Iterator[str]:
    start = pattern.find("{")
    if start == -1:
        yield pattern
        return

    # find matching close brace
    depth = 0
    end = -1
    for i in range(start, len(pattern)):
        if pattern[i] == "{":
            depth += 1
        elif pattern[i] == "}":
            depth -= 1
            if depth == 0:
                end = i
                break
    if end == -1:
        yield pattern
        return

    prefix, body, suffix = pattern[:start], pattern[start + 1:end], pattern[end + 1:]

    m = _RANGE_RE.match(body)
    if m:
        lo, hi = m.group(1), m.group(2)
        step = int(m.group(3)) if m.group(3) else 1
        width = len(lo) if lo.lstrip("-").startswith("0") or \
            hi.lstrip("-").startswith("0") else 0
        lo_i, hi_i = int(lo), int(hi)
        if lo_i <= hi_i:
            values = range(lo_i, hi_i + 1, abs(step) or 1)
        else:
            values = range(lo_i, hi_i - 1, -(abs(step) or 1))
        options = [str(v).zfill(width) for v in values]
    else:
        # split on top-level commas
        options, depth, cur = [], 0, []
        for ch in body:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
            if ch == "," and depth == 0:
                options.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        options.append("".join(cur))
        if len(options) == 1:  # `{single}` is not an expansion in bash
            yield prefix + "{" + body + "}" + suffix
            return

    for opt in options:
        for expanded_opt in braceexpand(opt):
            for rest in braceexpand(suffix):
                yield prefix + expanded_opt + rest
