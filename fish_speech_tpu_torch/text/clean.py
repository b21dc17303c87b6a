"""Text normalization (ref fish_speech/text/clean.py:24-37)."""

import re

SYMBOLS_MAPPING = {
    "‘": "'",
    "’": "'",
}

_REPLACE_RE = re.compile("|".join(re.escape(p) for p in SYMBOLS_MAPPING))

_EMOJI_RE = re.compile(
    "["
    "\U0001f600-\U0001f64f"
    "\U0001f300-\U0001f5ff"
    "\U0001f680-\U0001f6ff"
    "\U0001f1e0-\U0001f1ff"
    "]+",
    flags=re.UNICODE,
)


def clean_text(text: str) -> str:
    text = text.strip()
    text = _REPLACE_RE.sub(lambda x: SYMBOLS_MAPPING[x.group()], text)
    text = _EMOJI_RE.sub("", text)
    text = re.sub(r"[,]{2,}", lambda m: m.group()[0], text)
    return text
