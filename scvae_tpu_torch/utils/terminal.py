"""Terminal headings (the port's copy of ``scvae_tpu/utils/terminal.py``,
the reference's ``scvae/utilities.py:135-154, 216-247``)."""

from __future__ import annotations

import sys

_RESET = "\033[0m"
_BOLD = "\033[1m"
_UNDERLINE = "\033[4m"


def _supports_ansi() -> bool:
    return sys.stdout.isatty()


def _decorate(text: str, *codes: str) -> str:
    if not _supports_ansi():
        return text
    return "".join(codes) + text + _RESET


def title(text: str) -> None:
    bar = "=" * len(text)
    print(_decorate(bar + "\n" + text + "\n" + bar, _BOLD) + "\n")


def heading(text: str) -> None:
    print(_decorate(text, _BOLD, _UNDERLINE) + "\n")


def subheading(text: str) -> None:
    print(_decorate(text, _BOLD) + "\n")


def subtitle(text: str) -> None:
    print(_decorate(text, _UNDERLINE) + "\n")
