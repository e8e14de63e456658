"""String helpers with the reference's behaviour (the port's copy of
``format_time``, ``format_duration``, ``normalise_string``,
``proper_string`` and ``capitalise_string`` from
``scvae_tpu/utils/strings.py``): they take part in distribution-name
resolution, run naming, data-set names, the analyses' logs and the step
timer's summary, so they must give the JAX package's strings exactly."""

from __future__ import annotations

import re
import time
from math import floor


def format_time(t: float) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S %Z", time.localtime(t))


def format_duration(seconds: float) -> str:
    """The reference's ``scvae/utilities.py:36-60``."""
    if seconds < 0.001:
        return "<1 ms"
    if seconds < 1:
        return "{:.0f} ms".format(1000 * seconds)
    if seconds < 60:
        return "{:.3g} s".format(seconds)
    if seconds < 60 * 60:
        minutes = floor(seconds / 60)
        seconds = seconds % 60
        if round(seconds) == 60:
            seconds = 0
            minutes += 1
        return "{:.0f}m {:.0f}s".format(minutes, seconds)
    hours = floor(seconds / 60 / 60)
    minutes = floor((seconds / 60) % 60)
    seconds = seconds % 60
    if round(seconds) == 60:
        seconds = 0
        minutes += 1
    if minutes == 60:
        minutes = 0
        hours += 1
    return "{:.0f}h {:.0f}m {:.0f}s".format(hours, minutes, seconds)


def normalise_string(s: str) -> str:
    """Lower-case and squash separators/punctuation to underscores/nothing."""
    s = s.lower()
    replacements = {
        "_": [" ", "-", "/"],
        "": ["(", ")", ",", "$", "<", ">", ":", '"', "/", "\\", "|", "?", "*"],
    }
    for replacement, characters in replacements.items():
        pattern = "[" + re.escape("".join(characters)) + "]"
        s = re.sub(pattern, replacement, s)
    return s


def proper_string(
    original_string: str,
    translation: dict[str, list[str]],
    normalise: bool = True,
) -> str:
    """Map any alias in ``translation`` values back to its canonical key."""
    transformed = normalise_string(original_string) if normalise else original_string
    for proper, related in translation.items():
        if transformed in related:
            return proper
    return original_string


def capitalise_string(original_string: str) -> str:
    parts = re.split(pattern=r"(\s)", string=original_string, maxsplit=1)
    if len(parts) == 3:
        first_word, split_character, rest = parts
        if re.match(pattern=r"[A-Z]", string=first_word):
            capitalised_first = first_word
        else:
            capitalised_first = first_word.capitalize()
        return capitalised_first + split_character + rest
    if re.match(pattern=r"[A-Z]", string=original_string):
        return original_string
    return original_string.capitalize()
