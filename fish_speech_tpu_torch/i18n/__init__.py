"""UI localization: the locale files and the tool that keeps them in step
with the code's i18n() strings."""

from .core import I18nAuto, i18n

__all__ = ["I18nAuto", "i18n"]
