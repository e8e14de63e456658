"""Model-layer helpers (the ported part of
``scvae_tpu/models/utilities.py``)."""

from __future__ import annotations


def _parse_number_of_samples(number) -> int:
    if isinstance(number, (int, float)):
        if number % 1 == 0 and number > 0:
            return int(number)
    raise TypeError("Number of samples must be a positive integer.")


def parse_numbers_of_samples(proposed) -> dict[str, int]:
    """Normalise int / list / dict → {"training": n, "evaluation": n}."""
    required = ["training", "evaluation"]
    if isinstance(proposed, (int, float)):
        proposed = [_parse_number_of_samples(proposed)]
    if isinstance(proposed, list):
        if len(proposed) == 1:
            proposed = proposed * 2
        elif len(proposed) > 2:
            raise ValueError(
                "List of number of samples can only contain one or two "
                "numbers."
            )
        return {
            scenario: _parse_number_of_samples(n)
            for scenario, n in zip(required, proposed)
        }
    if isinstance(proposed, dict):
        parsed = {}
        for scenario in required:
            try:
                parsed[scenario] = _parse_number_of_samples(proposed.get(scenario))
            except TypeError:
                raise ValueError(
                    "To supply the numbers of samples as a dictionary, the "
                    "dictionary must contain the keys `training` and "
                    "`evaluation` with the number of samples for each given "
                    "as an integer."
                ) from None
        return parsed
    raise TypeError(
        f"Expected an `int`, `list`, or `dict`; got `{type(proposed)}`."
    )
