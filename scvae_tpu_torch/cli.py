"""Command-line interface: ``analyse``, ``train``, ``evaluate``,
``cross-analyse`` (the port of ``scvae_tpu/cli.py``, the reference's
``scvae/cli.py``), with the JAX package's subcommands, flags and defaults:

    python -m scvae_tpu_torch train development --split-data-set -e 10
    python -m scvae_tpu_torch evaluate development --split-data-set \\
        -P kmeans -K 3 --included-analyses metrics predictions latent_values

Models and analyses run on CUDA; ``main(argv, device="cpu")`` runs them on
the CPU.  Figures are drawn on the host and need matplotlib.  Loading a
data set goes through ``DataSet.load``'s HDF5 cache, which needs
``h5py``.  ``train -A`` runs the intermediate analyses at log-spaced
epochs, then the model analyses, as the JAX package does.
``cross-analyse`` reads the analyses' files on the host.
``--number-of-devices N`` trains and evaluates over a world of N
processes, one a device: ``torchrun --nproc-per-node N -m scvae_tpu_torch
train …``; ``--model-parallelism M`` cuts the reconstruction heads' genes
over M of them (the (data, model) mesh of N / M × M).
"""

from __future__ import annotations

import argparse
from typing import Any

import scvae_tpu_torch
from scvae_tpu_torch import analyses
from scvae_tpu_torch.analyses.prediction import (
    PredictionSpecifications,
    predict_labels,
)
from scvae_tpu_torch.data import DataSet
from scvae_tpu_torch.data.utilities import (
    build_directory_path,
    indices_for_evaluation_subset,
)
from scvae_tpu_torch.defaults import DEFAULTS as defaults
from scvae_tpu_torch.models import (
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch.models.naming import parse_model_versions
from scvae_tpu_torch.utils.strings import normalise_string
from scvae_tpu_torch.utils.terminal import heading, title


def _parse_default(default: Any) -> Any:
    if not isinstance(default, bool) and default != 0 and not default:
        default = None
    return default


def _load_data_set(
    data_set_file_or_name,
    data_format=None,
    data_directory=None,
    map_features=None,
    feature_selection=None,
    example_filter=None,
    preprocessing_methods=None,
    noisy_preprocessing_methods=None,
    split_data_set=None,
    splitting_method=None,
    splitting_fraction=None,
):
    data_set = DataSet(
        data_set_file_or_name,
        data_format=data_format,
        directory=data_directory or defaults["data"]["directory"],
        map_features=map_features,
        feature_selection=feature_selection,
        example_filter=example_filter,
        preprocessing_methods=preprocessing_methods,
        noisy_preprocessing_methods=noisy_preprocessing_methods,
    )
    if split_data_set:
        training_set, validation_set, test_set = data_set.split(
            method=splitting_method, fraction=splitting_fraction
        )
        data_set.clear()
        return data_set, (training_set, validation_set, test_set)
    data_set.load()
    return data_set, None


def _data_set_analyses_directory(
    analyses_directory,
    data_set,
    split_data_set,
    splitting_method,
    splitting_fraction,
):
    """Compose ``<analyses>/<data set>/<preprocessing…>/<split…>`` so runs
    on different data sets/preprocessings land in distinct subtrees that
    cross-analysis can group by (reference ``cli.py:88-93, 181-186,
    374-379``)."""
    if analyses_directory is None:
        analyses_directory = defaults["analyses"]["directory"]
    if not split_data_set:
        splitting_method = None
        splitting_fraction = None
    else:
        if splitting_method is None:
            splitting_method = defaults["data"]["splitting_method"]
        if splitting_fraction is None:
            splitting_fraction = defaults["data"]["splitting_fraction"]
    return build_directory_path(
        analyses_directory,
        data_set,
        splitting_method=splitting_method,
        splitting_fraction=splitting_fraction,
    )


def _given(**options) -> dict[str, Any]:
    """The options that are set: the port's constructors take a
    configuration option only when it is (the JAX ones read None as its
    default)."""
    return {name: value for name, value in options.items()
            if value is not None}


def _setup_model(
    data_set,
    model_type=None,
    latent_size=None,
    hidden_sizes=None,
    number_of_importance_samples=None,
    number_of_monte_carlo_samples=None,
    inference_architecture=None,
    latent_distribution=None,
    number_of_classes=None,
    parameterise_latent_posterior=False,
    prior_probabilities_method=None,
    generative_architecture=None,
    reconstruction_distribution=None,
    number_of_reconstruction_classes=None,
    count_sum=None,
    proportion_of_free_nats_for_y_kl_divergence=None,
    minibatch_normalisation=None,
    batch_correction=None,
    dropout_keep_probabilities=None,
    number_of_warm_up_epochs=None,
    kl_weight=None,
    models_directory=None,
):
    """Model factory (reference ``cli.py:601-689``; GMVAE
    ``prior_probabilities_method="infer"`` becomes a custom prior from the
    label frequencies)."""
    if model_type is None:
        model_type = defaults["models"]["type"]
    if batch_correction is None:
        batch_correction = defaults["models"]["batch_correction"]

    feature_size = data_set.number_of_features
    number_of_batches = data_set.number_of_batches
    if not data_set.has_batches:
        batch_correction = False

    common = dict(
        feature_size=feature_size,
        latent_size=latent_size,
        hidden_sizes=hidden_sizes,
        number_of_monte_carlo_samples=number_of_monte_carlo_samples,
        number_of_importance_samples=number_of_importance_samples,
        latent_distribution=latent_distribution,
        reconstruction_distribution=reconstruction_distribution,
        number_of_reconstruction_classes=number_of_reconstruction_classes,
        minibatch_normalisation=minibatch_normalisation,
        batch_correction=batch_correction,
        number_of_batches=number_of_batches,
        dropout_keep_probabilities=dropout_keep_probabilities,
        count_sum=count_sum,
        number_of_warm_up_epochs=number_of_warm_up_epochs,
        kl_weight=kl_weight,
        log_directory=models_directory,
    )

    if normalise_string(model_type) == "vae":
        return VariationalAutoencoder(**_given(
            inference_architecture=inference_architecture,
            generative_architecture=generative_architecture,
            parameterise_latent_posterior=parameterise_latent_posterior,
            **common,
        ))
    if normalise_string(model_type) == "gmvae":
        method_for_model = prior_probabilities_method
        prior_probabilities = None
        if prior_probabilities_method == "infer":
            method_for_model = "custom"
            probabilities_by_class = data_set.class_probabilities
            prior_probabilities = list(probabilities_by_class.values())
        return GaussianMixtureVariationalAutoencoder(**_given(
            number_of_latent_clusters=number_of_classes,
            prior_probabilities_method=method_for_model,
            prior_probabilities=prior_probabilities,
            proportion_of_free_nats_for_y_kl_divergence=(
                proportion_of_free_nats_for_y_kl_divergence
            ),
            **common,
        ))
    raise ValueError(f"Model type not found: `{model_type}`.")


# --------------------------------------------------------------------------
# Subcommands
# --------------------------------------------------------------------------


def analyse(
    data_set_file_or_name,
    data_format=None,
    data_directory=None,
    map_features=None,
    feature_selection=None,
    example_filter=None,
    preprocessing_methods=None,
    noisy_preprocessing_methods=None,
    split_data_set=None,
    splitting_method=None,
    splitting_fraction=None,
    included_analyses=None,
    analysis_level=None,
    decomposition_methods=None,
    highlight_feature_indices=None,
    export_options=None,
    analyses_directory=None,
    device=None,
    **_ignored,
):
    """Data-only analyses (reference ``cli.py:47-108``)."""
    title("Data analysis")
    data_set, subsets = _load_data_set(
        data_set_file_or_name,
        data_format=data_format,
        data_directory=data_directory,
        map_features=map_features,
        feature_selection=feature_selection,
        example_filter=example_filter,
        preprocessing_methods=preprocessing_methods,
        noisy_preprocessing_methods=noisy_preprocessing_methods,
        split_data_set=split_data_set,
        splitting_method=splitting_method,
        splitting_fraction=splitting_fraction,
    )
    data_sets = list(subsets) if subsets else [data_set]
    if isinstance(decomposition_methods, str):
        decomposition_methods = [decomposition_methods]
    analyses_directory = _data_set_analyses_directory(
        analyses_directory,
        data_set,
        split_data_set,
        splitting_method,
        splitting_fraction,
    )
    analyses.analyse_data(
        data_sets,
        decomposition_methods=decomposition_methods,
        highlight_feature_indices=highlight_feature_indices,
        included_analyses=included_analyses,
        analysis_level=analysis_level,
        export_options=export_options,
        analyses_directory=analyses_directory,
        device=device,
    )
    return 0


def train(
    data_set_file_or_name,
    data_format=None,
    data_directory=None,
    map_features=None,
    feature_selection=None,
    example_filter=None,
    preprocessing_methods=None,
    noisy_preprocessing_methods=None,
    split_data_set=None,
    splitting_method=None,
    splitting_fraction=None,
    model_type=None,
    latent_size=None,
    hidden_sizes=None,
    number_of_importance_samples=None,
    number_of_monte_carlo_samples=None,
    inference_architecture=None,
    latent_distribution=None,
    number_of_classes=None,
    parameterise_latent_posterior=False,
    prior_probabilities_method=None,
    generative_architecture=None,
    reconstruction_distribution=None,
    number_of_reconstruction_classes=None,
    count_sum=None,
    proportion_of_free_nats_for_y_kl_divergence=None,
    minibatch_normalisation=None,
    batch_correction=None,
    dropout_keep_probabilities=None,
    number_of_warm_up_epochs=None,
    kl_weight=None,
    number_of_epochs=None,
    minibatch_size=None,
    learning_rate=None,
    run_id=None,
    new_run=None,
    reset_training=None,
    models_directory=None,
    caches_directory=None,
    analyses_directory=None,
    number_of_devices=None,
    model_parallelism=None,
    device=None,
    **_ignored,
):
    """Train subcommand (reference ``cli.py:111-264``); with ``-A`` the
    intermediate analyses at log-spaced epochs and the model analyses after
    training (JAX ``cli.py:310-380``)."""
    title("Model training")
    data_set, subsets = _load_data_set(
        data_set_file_or_name,
        data_format=data_format,
        data_directory=data_directory,
        map_features=map_features,
        feature_selection=feature_selection,
        example_filter=example_filter,
        preprocessing_methods=preprocessing_methods,
        noisy_preprocessing_methods=noisy_preprocessing_methods,
        split_data_set=split_data_set,
        splitting_method=splitting_method,
        splitting_fraction=splitting_fraction,
    )
    if subsets:
        training_set, validation_set, _ = subsets
    else:
        training_set, validation_set = data_set, None

    if analyses_directory:
        analyses_directory = _data_set_analyses_directory(
            analyses_directory,
            training_set,
            split_data_set,
            splitting_method,
            splitting_fraction,
        )

    model = _setup_model(
        training_set,
        model_type=model_type,
        latent_size=latent_size,
        hidden_sizes=hidden_sizes,
        number_of_importance_samples=number_of_importance_samples,
        number_of_monte_carlo_samples=number_of_monte_carlo_samples,
        inference_architecture=inference_architecture,
        latent_distribution=latent_distribution,
        number_of_classes=number_of_classes,
        parameterise_latent_posterior=parameterise_latent_posterior,
        prior_probabilities_method=prior_probabilities_method,
        generative_architecture=generative_architecture,
        reconstruction_distribution=reconstruction_distribution,
        number_of_reconstruction_classes=number_of_reconstruction_classes,
        count_sum=count_sum,
        proportion_of_free_nats_for_y_kl_divergence=(
            proportion_of_free_nats_for_y_kl_divergence
        ),
        minibatch_normalisation=minibatch_normalisation,
        batch_correction=batch_correction,
        dropout_keep_probabilities=dropout_keep_probabilities,
        number_of_warm_up_epochs=number_of_warm_up_epochs,
        kl_weight=kl_weight,
        models_directory=models_directory,
    )
    heading(f"Training {model.type} model: {model.name}")

    intermediate_analyser = None
    if analyses_directory:
        def intermediate_analyser(
            epoch, latent_values, data_set, model_name, model_type,
            run_id, analyses_directory=analyses_directory, **_ignored,
        ):
            analyses.analyse_intermediate_results(
                epoch=epoch,
                latent_values=latent_values,
                data_set=data_set,
                model_name=model_name,
                model_type=model_type,
                run_id=run_id,
                analyses_directory=analyses_directory,
                device=device,
            )

    model.train(
        training_set,
        validation_set,
        number_of_epochs=number_of_epochs,
        minibatch_size=minibatch_size,
        learning_rate=learning_rate,
        run_id=run_id or None,
        new_run=bool(new_run),
        reset_training=bool(reset_training),
        intermediate_analyser=intermediate_analyser,
        analyses_directory=analyses_directory,
        caches_directory=caches_directory,
        number_of_devices=number_of_devices,
        model_parallelism=model_parallelism,
        device=device,
    )
    if analyses_directory:
        # the library's default analyses: the train subcommand has no
        # --included-analyses flag (JAX cli.py:370-379)
        analyses.analyse_model(
            model, run_id=run_id or None,
            included_analyses=None,
            analyses_directory=analyses_directory,
            device=device,
        )
    return 0


def evaluate(
    data_set_file_or_name,
    data_format=None,
    data_directory=None,
    map_features=None,
    feature_selection=None,
    example_filter=None,
    preprocessing_methods=None,
    noisy_preprocessing_methods=None,
    split_data_set=None,
    splitting_method=None,
    splitting_fraction=None,
    model_type=None,
    latent_size=None,
    hidden_sizes=None,
    number_of_importance_samples=None,
    number_of_monte_carlo_samples=None,
    inference_architecture=None,
    latent_distribution=None,
    number_of_classes=None,
    parameterise_latent_posterior=False,
    prior_probabilities_method=None,
    generative_architecture=None,
    reconstruction_distribution=None,
    number_of_reconstruction_classes=None,
    count_sum=None,
    proportion_of_free_nats_for_y_kl_divergence=None,
    minibatch_normalisation=None,
    batch_correction=None,
    dropout_keep_probabilities=None,
    number_of_warm_up_epochs=None,
    kl_weight=None,
    minibatch_size=None,
    run_id=None,
    models_directory=None,
    evaluation_set_kind=None,
    sample_size=None,
    prediction_method=None,
    prediction_training_set_kind=None,
    model_versions=None,
    included_analyses=None,
    analysis_level=None,
    decomposition_methods=None,
    highlight_feature_indices=None,
    export_options=None,
    analyses_directory=None,
    number_of_devices=None,
    model_parallelism=None,
    device=None,
    **_ignored,
):
    """Evaluate subcommand (reference ``cli.py:267-566``): restores the
    model, evaluates the requested model versions, optionally samples and
    predicts labels, and runs the result analyses."""
    title("Model evaluation")
    if evaluation_set_kind is None:
        evaluation_set_kind = defaults["evaluation"]["data_set_kind"]
    if prediction_training_set_kind is None:
        prediction_training_set_kind = defaults["evaluation"][
            "prediction_training_set_kind"
        ]
    evaluation_set_kind = normalise_string(evaluation_set_kind)
    prediction_training_set_kind = normalise_string(
        prediction_training_set_kind
    )
    model_versions = parse_model_versions(model_versions or "all")

    data_set, subsets = _load_data_set(
        data_set_file_or_name,
        data_format=data_format,
        data_directory=data_directory,
        map_features=map_features,
        feature_selection=feature_selection,
        example_filter=example_filter,
        preprocessing_methods=preprocessing_methods,
        noisy_preprocessing_methods=noisy_preprocessing_methods,
        split_data_set=split_data_set,
        splitting_method=splitting_method,
        splitting_fraction=splitting_fraction,
    )
    if subsets:
        by_kind = dict(zip(("training", "validation", "test"), subsets))
        by_kind["full"] = data_set
    else:
        by_kind = {"full": data_set, evaluation_set_kind: data_set}
    evaluation_set = by_kind[evaluation_set_kind]
    prediction_training_set = by_kind.get(prediction_training_set_kind)

    model = _setup_model(
        evaluation_set,
        model_type=model_type,
        latent_size=latent_size,
        hidden_sizes=hidden_sizes,
        number_of_importance_samples=number_of_importance_samples,
        number_of_monte_carlo_samples=number_of_monte_carlo_samples,
        inference_architecture=inference_architecture,
        latent_distribution=latent_distribution,
        number_of_classes=number_of_classes,
        parameterise_latent_posterior=parameterise_latent_posterior,
        prior_probabilities_method=prior_probabilities_method,
        generative_architecture=generative_architecture,
        reconstruction_distribution=reconstruction_distribution,
        number_of_reconstruction_classes=number_of_reconstruction_classes,
        count_sum=count_sum,
        proportion_of_free_nats_for_y_kl_divergence=(
            proportion_of_free_nats_for_y_kl_divergence
        ),
        minibatch_normalisation=minibatch_normalisation,
        batch_correction=batch_correction,
        dropout_keep_probabilities=dropout_keep_probabilities,
        number_of_warm_up_epochs=number_of_warm_up_epochs,
        kl_weight=kl_weight,
        models_directory=models_directory,
    )

    if not model.has_been_trained(run_id=run_id or None):
        raise SystemExit(
            f"No trained model found in {model.log_directory(run_id=run_id or None)}"
        )

    # keep only available versions (reference cli.py:415-429)
    versions_available = []
    for version in model_versions:
        if version == "end_of_training":
            versions_available.append(version)
        elif version == "best_model" and model.better_model_exists(
            run_id=run_id or None
        ):
            versions_available.append(version)
        elif version == "early_stopping" and model.model_stopped_early(
            run_id=run_id or None
        ):
            versions_available.append(version)
    model_versions = versions_available

    analyses_directory = _data_set_analyses_directory(
        analyses_directory,
        evaluation_set,
        split_data_set,
        splitting_method,
        splitting_fraction,
    )
    analyses.analyse_model(
        model, run_id=run_id or None,
        included_analyses=included_analyses,
        analyses_directory=analyses_directory,
        device=device,
    )

    subset_indices = indices_for_evaluation_subset(evaluation_set)

    for version in model_versions:
        heading(f"Evaluating model version: {version}")
        use_best = version == "best_model"
        use_early = version == "early_stopping"
        transformed, reconstructed, latent = model.evaluate(
            evaluation_set,
            minibatch_size=minibatch_size,
            run_id=run_id or None,
            use_best_model=use_best,
            use_early_stopping_model=use_early,
            output_versions="all",
            number_of_devices=number_of_devices,
            model_parallelism=model_parallelism,
            device=device,
        )
        evaluation_metrics = model._last_evaluation_metrics

        if sample_size:
            try:
                model.sample(
                    sample_size=sample_size,
                    minibatch_size=minibatch_size,
                    run_id=run_id or None,
                    use_best_model=use_best,
                    use_early_stopping_model=use_early,
                    device=device,
                )
            except NotImplementedError as error:
                print(f"Sampling skipped: {error}")

        if prediction_method and prediction_training_set is not None:
            n_clusters = number_of_classes or (
                evaluation_set.number_of_classes or 2
            )
            specifications = PredictionSpecifications(
                method=prediction_method,
                number_of_clusters=n_clusters,
                training_set_kind=prediction_training_set.kind,
            )
            latent_training = model.evaluate(
                prediction_training_set,
                minibatch_size=minibatch_size,
                run_id=run_id or None,
                use_best_model=use_best,
                use_early_stopping_model=use_early,
                output_versions="latent",
                verbose=False,
                number_of_devices=number_of_devices,
                model_parallelism=model_parallelism,
                device=device,
            )
            latent_evaluation = latent["z"] if isinstance(latent, dict) else latent
            training_latent = (
                latent_training["z"]
                if isinstance(latent_training, dict)
                else latent_training
            )
            cluster_ids, predicted_labels, predicted_superset_labels = (
                predict_labels(
                    training_latent,
                    latent_evaluation,
                    specifications=specifications,
                    device=device,
                )
            )
            for output_set in (transformed, reconstructed):
                output_set.update_predictions(
                    prediction_specifications=specifications,
                    predicted_cluster_ids=cluster_ids,
                    predicted_labels=predicted_labels,
                    predicted_superset_labels=predicted_superset_labels,
                )
            # the metrics logs are the evaluation set's: the JAX package
            # logs those of the prediction's training set here
            model._last_evaluation_metrics = evaluation_metrics

        latent_sets = latent if isinstance(latent, dict) else {"z": latent}
        analyses.analyse_results(
            transformed,
            reconstructed,
            latent_sets,
            model,
            run_id=run_id or None,
            decomposition_methods=(
                [decomposition_methods]
                if isinstance(decomposition_methods, str)
                else decomposition_methods
            ),
            evaluation_subset_indices=subset_indices,
            highlight_feature_indices=highlight_feature_indices,
            best_model=use_best,
            early_stopping=use_early,
            included_analyses=included_analyses,
            analysis_level=analysis_level,
            export_options=export_options,
            analyses_directory=analyses_directory,
            device=device,
        )
    return 0


def cross_analyse(
    analyses_directory,
    include_data_sets=None,
    exclude_data_sets=None,
    include_models=None,
    exclude_models=None,
    include_prediction_methods=None,
    exclude_prediction_methods=None,
    extra_model_specification_for_plots=None,
    no_prediction_methods_for_gmvae_in_plots=False,
    epoch_cut_off=None,
    other_methods=None,
    export_options=None,
    log_summary=None,
    **_ignored,
):
    """Cross-analyse subcommand (reference ``cli.py:569-598``), on the
    host: no device takes part."""
    analyses.cross_analyse(
        analyses_directory,
        data_set_included_strings=include_data_sets,
        data_set_excluded_strings=exclude_data_sets,
        model_included_strings=include_models,
        model_excluded_strings=exclude_models,
        prediction_included_strings=include_prediction_methods,
        prediction_excluded_strings=exclude_prediction_methods,
        additional_other_option=extra_model_specification_for_plots,
        no_prediction_methods_for_gmvae_in_plots=(
            no_prediction_methods_for_gmvae_in_plots
        ),
        epoch_cut_off=epoch_cut_off,
        other_methods=other_methods,
        export_options=export_options,
        log_summary=log_summary,
    )
    return 0


# --------------------------------------------------------------------------
# Argument parser (reference cli.py:698-1239)
# --------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="scvae-tpu-torch",
        description=scvae_tpu_torch.__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "--version",
        "-V",
        action="version",
        version="%(prog)s {}".format(scvae_tpu_torch.__version__),
    )
    subparsers = parser.add_subparsers(help="commands", dest="command")
    subparsers.required = True

    data_set_subparsers = []
    model_subparsers = []
    training_subparsers = []
    evaluation_subparsers = []
    analysis_subparsers = []

    parser_analyse = subparsers.add_parser(
        name="analyse",
        description="Analyse single-cell transcript counts.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser_analyse.set_defaults(func=analyse)
    data_set_subparsers.append(parser_analyse)
    analysis_subparsers.append(parser_analyse)

    parser_train = subparsers.add_parser(
        name="train",
        description="Train model on single-cell transcript counts.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser_train.set_defaults(func=train)
    data_set_subparsers.append(parser_train)
    model_subparsers.append(parser_train)
    training_subparsers.append(parser_train)

    parser_evaluate = subparsers.add_parser(
        name="evaluate",
        description="Evaluate model on single-cell transcript counts.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser_evaluate.set_defaults(func=evaluate)
    data_set_subparsers.append(parser_evaluate)
    model_subparsers.append(parser_evaluate)
    evaluation_subparsers.append(parser_evaluate)
    analysis_subparsers.append(parser_evaluate)

    parser_cross = subparsers.add_parser(
        name="cross-analyse",
        description="Cross-analyse models and results on withheld data sets.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser_cross.set_defaults(func=cross_analyse)

    for subparser in data_set_subparsers:
        subparser.add_argument(
            dest="data_set_file_or_name",
            help="data set name or path to data set file",
        )
        subparser.add_argument(
            "--format", "-f", dest="data_format", metavar="FORMAT",
            default=_parse_default(defaults["data"]["format"]),
            help="format of the data set",
        )
        subparser.add_argument(
            "--data-directory", "-D", metavar="DIRECTORY",
            default=_parse_default(defaults["data"]["directory"]),
            help="directory where data are placed or copied",
        )
        subparser.add_argument(
            "--map-features", action="store_true",
            default=_parse_default(defaults["data"]["map_features"]),
            help="map features using a feature mapping, if available",
        )
        subparser.add_argument(
            "--feature-selection", "-F", metavar="SELECTION", nargs="+",
            default=_parse_default(defaults["data"]["feature_selection"]),
            help="method for selecting features",
        )
        subparser.add_argument(
            "--example-filter", "-E", metavar="FILTER", nargs="+",
            default=_parse_default(defaults["data"]["example_filter"]),
            help="method for filtering examples, optionally with parameters",
        )
        subparser.add_argument(
            "--preprocessing-methods", "-p", metavar="METHOD", nargs="+",
            default=_parse_default(defaults["data"]["preprocessing_methods"]),
            help="methods for preprocessing data (applied in order)",
        )
        subparser.add_argument(
            "--noisy-preprocessing-methods", "--np", metavar="METHOD",
            nargs="+",
            default=_parse_default(
                defaults["data"]["noisy_preprocessing_methods"]
            ),
            help="methods for noisily preprocessing data (applied in order)",
        )
        subparser.add_argument(
            "--split-data-set", action="store_true",
            default=_parse_default(defaults["data"]["split_data_set"]),
            help="split data set into training, validation, and test sets",
        )
        subparser.add_argument(
            "--splitting-method", metavar="METHOD",
            default=_parse_default(defaults["data"]["splitting_method"]),
            help="method for splitting data",
        )
        subparser.add_argument(
            "--splitting-fraction", metavar="FRACTION", type=float,
            default=_parse_default(defaults["data"]["splitting_fraction"]),
            help="fraction to use when splitting data",
        )

    for subparser in model_subparsers:
        subparser.add_argument(
            "--model-type", "-m", metavar="TYPE",
            default=_parse_default(defaults["models"]["type"]),
            help="type of model; either VAE or GMVAE",
        )
        subparser.add_argument(
            "--latent-size", "-l", metavar="SIZE", type=int,
            default=_parse_default(defaults["models"]["latent_size"]),
            help="size of latent space",
        )
        subparser.add_argument(
            "--hidden-sizes", "-H", metavar="SIZE", type=int, nargs="+",
            default=_parse_default(defaults["models"]["hidden_sizes"]),
            help="sizes of hidden layers",
        )
        subparser.add_argument(
            "--number-of-importance-samples", metavar="NUMBER", type=int,
            nargs="+",
            default=_parse_default(defaults["models"]["number_of_samples"]),
            help="the number of importance-weighted samples "
            "(training [evaluation])",
        )
        subparser.add_argument(
            "--number-of-monte-carlo-samples", metavar="NUMBER", type=int,
            nargs="+",
            default=_parse_default(defaults["models"]["number_of_samples"]),
            help="the number of Monte Carlo samples (training [evaluation])",
        )
        subparser.add_argument(
            "--inference-architecture", metavar="KIND",
            default=_parse_default(
                defaults["models"]["inference_architecture"]
            ),
            help="architecture of the inference model",
        )
        subparser.add_argument(
            "--latent-distribution", "-q", metavar="DISTRIBUTION",
            help="distribution for the latent variable(s)",
        )
        subparser.add_argument(
            "--number-of-classes", "-K", metavar="NUMBER", type=int,
            help="number of proposed clusters in data set",
        )
        subparser.add_argument(
            "--parameterise-latent-posterior", action="store_true",
            default=_parse_default(
                defaults["models"]["parameterise_latent_posterior"]
            ),
            help="parameterise latent posterior parameters, if possible",
        )
        subparser.add_argument(
            "--generative-architecture", metavar="KIND",
            default=_parse_default(
                defaults["models"]["generative_architecture"]
            ),
            help="architecture of the generative model",
        )
        subparser.add_argument(
            "--reconstruction-distribution", "-r", metavar="DISTRIBUTION",
            default=_parse_default(
                defaults["models"]["reconstruction_distribution"]
            ),
            help="distribution for the reconstructions",
        )
        subparser.add_argument(
            "--number-of-reconstruction-classes", "-k", metavar="NUMBER",
            type=int,
            default=_parse_default(
                defaults["models"]["number_of_reconstruction_classes"]
            ),
            help="the maximum count for which to use classification",
        )
        subparser.add_argument(
            "--prior-probabilities-method", metavar="METHOD",
            default=_parse_default(
                defaults["models"]["prior_probabilities_method"]
            ),
            help="method to set prior probabilities",
        )
        subparser.add_argument(
            "--number-of-warm-up-epochs", "-w", metavar="NUMBER", type=int,
            default=_parse_default(
                defaults["models"]["number_of_warm_up_epochs"]
            ),
            help="number of initial epochs with a linear KL weight",
        )
        subparser.add_argument(
            "--kl-weight", metavar="WEIGHT", type=float,
            default=_parse_default(defaults["models"]["kl_weight"]),
            help="weighting of KL divergence",
        )
        subparser.add_argument(
            "--proportion-of-free-nats-for-y-kl-divergence",
            metavar="PROPORTION", type=float,
            default=_parse_default(
                defaults["models"][
                    "proportion_of_free_nats_for_y_kl_divergence"
                ]
            ),
            help="proportion of maximum y KL divergence for the GMVAE "
            "(free-bits method)",
        )
        subparser.add_argument(
            "--minibatch-normalisation", "-b", action="store_true",
            default=_parse_default(
                defaults["models"]["minibatch_normalisation"]
            ),
            help="use batch normalisation for minibatches in models",
        )
        subparser.add_argument(
            "--batch-correction", "--bc", action="store_true",
            default=_parse_default(defaults["models"]["batch_correction"]),
            help="use batch correction in models",
        )
        subparser.add_argument(
            "--dropout-keep-probabilities", metavar="PROBABILITY",
            type=float, nargs="+",
            default=_parse_default(
                defaults["models"]["dropout_keep_probabilities"]
            ),
            help="probabilities of keeping connections when using dropout",
        )
        subparser.add_argument(
            "--count-sum", action="store_true",
            default=_parse_default(defaults["models"]["count_sum"]),
            help="use count sum",
        )
        subparser.add_argument(
            "--minibatch-size", "-B", metavar="SIZE", type=int,
            default=_parse_default(defaults["models"]["minibatch_size"]),
            help="minibatch size for stochastic optimisation algorithm",
        )
        subparser.add_argument(
            "--number-of-devices", metavar="N", type=int, default=None,
            help=(
                "number of accelerator devices for the (data, model) mesh:"
                " a world of as many processes, one a device (torchrun"
                " --nproc-per-node N)"
            ),
        )
        subparser.add_argument(
            "--model-parallelism", metavar="M", type=int, default=None,
            help=(
                "tensor-parallel factor sharding the gene-axis"
                " reconstruction heads over the model mesh axis"
            ),
        )
        subparser.add_argument(
            "--run-id", metavar="ID", type=str,
            default=_parse_default(defaults["models"]["run_id"]),
            help="ID for separate run of the model",
        )
        subparser.add_argument(
            "--models-directory", "-M", metavar="DIRECTORY",
            default=_parse_default(defaults["models"]["directory"]),
            help="directory where models are stored",
        )

    for subparser in training_subparsers:
        subparser.add_argument(
            "--number-of-epochs", "-e", metavar="NUMBER", type=int,
            default=_parse_default(defaults["models"]["number_of_epochs"]),
            help="number of epochs for which to train",
        )
        subparser.add_argument(
            "--learning-rate", metavar="RATE", type=float,
            default=_parse_default(defaults["models"]["learning_rate"]),
            help="learning rate when training",
        )
        subparser.add_argument(
            "--new-run", action="store_true",
            default=_parse_default(defaults["models"]["new_run"]),
            help="train a model anew as a separate run",
        )
        subparser.add_argument(
            "--reset-training", action="store_true",
            default=_parse_default(defaults["models"]["reset_training"]),
            help="reset already trained model",
        )
        subparser.add_argument(
            "--caches-directory", "-C", metavar="DIRECTORY",
            help="directory for temporary storage",
        )
        subparser.add_argument(
            "--analyses-directory", "-A", metavar="DIRECTORY", default=None,
            help="directory where analyses are saved",
        )

    for subparser in analysis_subparsers:
        subparser.add_argument(
            "--included-analyses", metavar="ANALYSIS", nargs="+",
            default=_parse_default(defaults["analyses"]["included_analyses"]),
            help="analyses to perform (individually or as groups: "
            "simple, standard, all)",
        )
        subparser.add_argument(
            "--analysis-level", metavar="LEVEL",
            default=_parse_default(defaults["analyses"]["analysis_level"]),
            help="level to which analyses are performed: "
            "limited, normal, extensive",
        )
        subparser.add_argument(
            "--decomposition-methods", metavar="METHOD", nargs="+",
            default=_parse_default(
                defaults["analyses"]["decomposition_method"]
            ),
            help="methods used to decompose values",
        )
        subparser.add_argument(
            "--highlight-feature-indices", metavar="INDEX", type=int,
            nargs="+",
            default=_parse_default(
                defaults["analyses"]["highlight_feature_indices"]
            ),
            help="feature indices to highlight in analyses",
        )
        subparser.add_argument(
            "--export-options", metavar="OPTION", nargs="+",
            default=_parse_default(defaults["analyses"]["export_options"]),
            help="export options for analyses",
        )
        if subparser is not parser_train:
            subparser.add_argument(
                "--analyses-directory", "-A", metavar="DIRECTORY",
                default=_parse_default(defaults["analyses"]["directory"]),
                help="directory where analyses are saved",
            )

    for subparser in evaluation_subparsers:
        subparser.add_argument(
            "--evaluation-set-kind", metavar="KIND",
            default=_parse_default(defaults["evaluation"]["data_set_kind"]),
            help="kind of subset to evaluate and analyse: "
            "training, validation, test (default), or full",
        )
        subparser.add_argument(
            "--sample-size", metavar="SIZE", type=int,
            default=_parse_default(defaults["models"]["sample_size"]),
            help="sample size for sampling model",
        )
        subparser.add_argument(
            "--prediction-method", "-P", metavar="METHOD",
            default=_parse_default(
                defaults["evaluation"]["prediction_method"]
            ),
            help="method for predicting labels",
        )
        subparser.add_argument(
            "--prediction-training-set-kind", metavar="KIND",
            default=_parse_default(
                defaults["evaluation"]["prediction_training_set_kind"]
            ),
            help="kind of subset to train prediction method on",
        )
        subparser.add_argument(
            "--model-versions", metavar="VERSION", nargs="+",
            default=_parse_default(defaults["evaluation"]["model_versions"]),
            help="model versions to evaluate: end-of-training, best-model, "
            "early-stopping",
        )

    parser_cross.add_argument(
        "analyses_directory", metavar="ANALYSES_DIRECTORY",
        help="directory where analyses were saved",
    )
    parser_cross.add_argument(
        "--include-data-sets", "-d", metavar="TEXT", nargs="+",
        help="only include data sets that match TEXT",
    )
    parser_cross.add_argument(
        "--exclude-data-sets", "-D", metavar="TEXT", nargs="+",
        help="exclude data sets that match TEXT",
    )
    parser_cross.add_argument(
        "--include-models", "-m", metavar="TEXT", nargs="+",
        help="only include models that match TEXT",
    )
    parser_cross.add_argument(
        "--exclude-models", "-M", metavar="TEXT", nargs="+",
        help="exclude models that match TEXT",
    )
    parser_cross.add_argument(
        "--include-prediction-methods", "-p", metavar="TEXT", nargs="+",
        help="only include prediction methods that match TEXT",
    )
    parser_cross.add_argument(
        "--exclude-prediction-methods", "-P", metavar="TEXT", nargs="+",
        help="exclude prediction methods that match TEXT",
    )
    parser_cross.add_argument(
        "--extra-model-specification-for-plots", "-a",
        metavar="SPECIFICATION", dest="extra_model_specification_for_plots",
        help="extra model specification required in model metrics plots",
    )
    parser_cross.add_argument(
        "--no-prediction-methods-for-gmvae-in-plots", action="store_true",
        default=False,
        help="do not include prediction methods for GMVAE in plots",
    )
    parser_cross.add_argument(
        "--epoch-cut-off", "-e", metavar="EPOCH_NUMBER", type=int,
        help="exclude models trained for longer than this many epochs",
    )
    parser_cross.add_argument(
        "--other-methods", "-o", metavar="METHOD", nargs="+",
        help="other methods to plot in model metrics plot, if available",
    )
    parser_cross.add_argument(
        "--export-options", metavar="OPTION", nargs="+",
        default=_parse_default(defaults["analyses"]["export_options"]),
        help="export options for cross-analyses",
    )
    parser_cross.add_argument(
        "--log-summary", "-s", action="store_true",
        default=_parse_default(defaults["cross_analysis"]["log_summary"]),
        help="log summary (saved in ANALYSES_DIRECTORY)",
    )

    return parser


def main(argv=None, device=None) -> int:
    """Run the subcommand of ``argv``; the models and analyses run on
    ``device`` (CUDA unless ``"cpu"``)."""
    parser = build_parser()
    arguments = vars(parser.parse_args(argv))
    arguments.pop("command", None)
    func = arguments.pop("func")
    return func(**arguments, device=device) or 0


if __name__ == "__main__":
    raise SystemExit(main())
