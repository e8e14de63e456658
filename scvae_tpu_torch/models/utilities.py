"""Model-layer helpers (the port's copy of
``scvae_tpu/models/utilities.py``: sample counts, the cross-parameter
validation and the early-stopping status of a validation curve)."""

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


def _enumerate(strings: list[str], conjunction: str) -> str:
    if len(strings) == 1:
        return strings[0]
    if len(strings) == 2:
        return f"{strings[0]} {conjunction} {strings[1]}"
    return f"{', '.join(strings[:-1])}, {conjunction} {strings[-1]}"


def validate_model_parameters(
    reconstruction_distribution=None,
    number_of_reconstruction_classes=None,
    model_type=None,
    latent_distribution=None,
    parameterise_latent_posterior=None,
):
    """The reference's cross-parameter validation: no piecewise-categorical
    Bernoulli, zero-inflated or constrained likelihood, and a parameterised
    latent posterior only for a VAE with a Gaussian-mixture latent."""
    if reconstruction_distribution and number_of_reconstruction_classes:
        if number_of_reconstruction_classes > 0:
            errors = []
            if reconstruction_distribution == "bernoulli":
                errors.append("the Bernoulli distribution")
            if "zero-inflated" in reconstruction_distribution:
                errors.append("zero-inflated distributions")
            if "constrained" in reconstruction_distribution:
                errors.append("constrained distributions")
            if errors:
                message = _enumerate(errors, "or")
                raise ValueError(f"{message[0].upper()}{message[1:]} cannot "
                                 "be piecewise categorical.")

    if model_type and latent_distribution and parameterise_latent_posterior:
        if "VAE" in model_type:
            if not (
                model_type == "VAE"
                and latent_distribution == "gaussian mixture"
            ):
                raise ValueError(
                    "Cannot parameterise latent posterior parameters for "
                    f"{model_type} or {latent_distribution} distribution."
                )


def early_stopping_status(
    validation_metrics: list[float], early_stopping_rounds: int
) -> tuple[bool, int]:
    """(stopped_early, epochs_without_improvement) rebuilt from a validation
    curve."""
    stopped_early = False
    epochs_without_improvement = 0
    if validation_metrics:
        best = -float("inf")
        for metric in validation_metrics:
            if metric > best:
                best = metric
                epochs_without_improvement = 0
            else:
                epochs_without_improvement += 1
        stopped_early = epochs_without_improvement >= early_stopping_rounds
    return stopped_early, epochs_without_improvement
