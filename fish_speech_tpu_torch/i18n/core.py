"""UI localization (ref fish_speech/i18n/core.py:16-40): locale json files
keyed by UI string, chosen from the system locale or a `.locale` file in
the working directory.

Counterpart of `fish_speech_tpu/i18n/core.py`, with its own copy of the
locale files. The default translator is made at the first `i18n()` call,
not when the module is imported.
"""

from __future__ import annotations

import functools
import json
import locale
from pathlib import Path

I18N_FILE_PATH = Path(__file__).parent / "locale"
DEFAULT_LANGUAGE = "en_US"


def load_language_list(language: str) -> dict:
    with open(I18N_FILE_PATH / f"{language}.json", "r", encoding="utf-8") as f:
        return json.load(f)


class I18nAuto:
    def __init__(self, language: str | None = None):
        if language is None:
            override = Path(".locale")
            if override.exists():
                language = override.read_text(encoding="utf-8").strip()
            else:
                try:
                    language = locale.getlocale()[0]
                except ValueError:
                    language = None
        if not language or not (I18N_FILE_PATH / f"{language}.json").exists():
            language = DEFAULT_LANGUAGE
        self.language = language
        self.language_map = load_language_list(language)

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)

    def __repr__(self) -> str:
        return "Use Language: " + self.language


@functools.cache
def default_i18n() -> I18nAuto:
    """The process's translator, made once."""
    return I18nAuto()


def i18n(key: str) -> str:
    """`key` in the default language (`default_i18n`), or itself."""
    return default_i18n()(key)
