"""String helpers with the reference's behaviour (the port's copy of
``normalise_string`` and ``proper_string`` from
``scvae_tpu/utils/strings.py``): they take part in distribution-name
resolution, run naming and data-set names, so they must give the JAX
package's strings exactly."""

from __future__ import annotations

import re


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
