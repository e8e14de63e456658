"""Analyses of trained models (the ported parts of ``scvae_tpu/analyses/``)."""
