#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``scvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (a failure raises and exits non-zero):

1. card    — the GPU's name and power limit, torch and CUDA versions;
2. build   — compile the kernels of ``scvae_tpu_torch/ops/csrc`` for sm_90a;
3. kernels — every kernel of the training paths
             against its plain PyTorch version on the same inputs at the
             headline shapes (68,579
             cells × 2,048 genes, minibatch 2,048, decoder width 256) for
             every likelihood family, the categorised instances with 14 heads (ZINB,
             K = 10) and with the cap of 32 (Poisson, K = 30) on targets of
             which every other row is drawn as Poisson(K), NB's K2/K3 over
             the GMVAE's 20,480 decoder rows (K = 10 clusters) against 2,048
             cycled target rows, at decoder width 1,024, NB's K2 and
             K3's three kernels at the LFM decoder's widths 100, 101 and
             105 (padded to 104, 104 and 112), and at the over-budget set's
             4,096 genes (entries "nb_4096_…"); the gene split's
             block launches (``check_gene_blocks``: NB over 2,048 and
             20,480 rows, categorised ZINB with K = 10, the heads of
             2,048 genes in two blocks of 1,024 through ``ops.sharded``'s
             split Functions with no group, summed and put together
             against the whole-F kernels and the plain versions, each
             block's time beside the whole-F time); with its time,
             the plain version's time, the least time the card could take
             and, for the products, one ``torch.mm`` of the same product
             (dW: the product alone, db not included);
4. slice   — for each trained configuration, the headline VAE with each
             likelihood (Poisson, zero-inflated Poisson, zero-inflated NB,
             constrained Poisson, NB), VAE-NB-f32 (NB with
             precision="float32": the float32 K2/K3, h, W and da as bf16
             terms on the tensor cores), VAE-CP-f32 (the constrained
             Poisson likewise: its float32 K6/K7), VAE-ZINB-cat (K = 10
             classes, 14 heads),
             VAE-Poisson-cat (K = 30, 32 heads, on counts of mean 31 that
             reach K), VAE-Poisson-cat-f32 (the same with
             precision="float32": the categorised float32 K2/K3) and
             GMVAE-NB (10 clusters): one
             training loss and its gradients on the CPU (plain versions) and
             on the GPU (kernels) from the same small input, then
             ``VariationalAutoencoder(...).train(...)`` or
             ``GaussianMixtureVariationalAutoencoder(...).train(...)`` at the
             headline width for two epochs, each into an emptied directory
             under ``build/`` (VAE-ZINB-cat, which the API refuses as the JAX
             API does, through the config-level functions as the JAX
             package's ``bench.py`` config 3): a finite, rising ELBO, and
             each of the configuration's likelihood kernels launched exactly
             once per training step (GMVAE-NB: once over all clusters, not K
             times), a VAE's float32 forward of its likelihood (``…_forward_
             float32``) besides once per batch of the per-epoch evaluations
             (the remainder batch included: the evaluation passes take the
             float32 fused forward on CUDA; the GMVAE's the unfused path), no
             other likelihood kernel, the row gather at least once.  Training and
             the full-batch evaluation steps run as CUDA graph replays (the
             entry points' default on CUDA), and the counters count each
             replay's launches;
4a. trace  — the main path under ``utils.profiling.trace``: the headline
             VAE-NB through ``VariationalAutoencoder.train`` for two
             epochs with the span recorder (``utils/tracing.py``) on, and
             ``trace`` around epoch 2 (a gzip'd Chrome trace under
             ``build/trace``); ``summarize_trace`` of it holds K2's and
             K3's heads kernel (``tc_heads_kernel``, which the
             evaluation's float32 K2 runs too), the products
             (``tc_product_kernel``) and K1 (``gather_vector_kernel``) by
             name, each name's count equal to the launches the counters
             took in epoch 2 (graph replays included), and the
             ``epoch.train`` span as a ``user_annotation``; the
             ``epoch.train`` spans equal ``epoch_seconds`` within 1 ms an
             epoch, and ``device_memory_stats()`` reads 0 < bytes in use
             ≤ the limit; prints each kernel's events, time and rank, the
             spans of each epoch and, on a line of its own, the trace's
             ten largest entries;
4d. options — one training loss of the headline VAE-NB and its
             gradients, fused against unfused on the same inputs (the loss
             within 4e-4 relative; the gradients within 4e-4 of the
             largest in float32, within 5e-3 in norm with bf16 inputs);
             then each OPTIONS configuration (VAE-NB unfused; VAE-NB with
             4 batch indices from RandomState(3), batch correction and the
             count sum; VAE-NB-LFM, both architectures LFM with the same
             inputs; GMVAE-NB-full, the full-covariance mixture with 10
             clusters; VAE-Poisson-cat-40, 42 heads, unfused; a VAE per
             other reconstruction distribution: Bernoulli on the counts
             binarised, gaussian, log-normal, lomax, EMG and gaussian
             mixture on the counts, gamma on the counts + 1, multivariate
             gaussian on the first 128 genes): phase 4's small step, then
             two epochs through the API at the headline width: a finite,
             rising ELBO, K1 at least once a step, NB's K2 and K3's three
             kernels once a step on the fused configurations and no
             likelihood kernel on the unfused ones, GMVAE-NB-full's prior
             covariance matrices in ``centroids.json`` symmetric positive
             definite, and each configuration's steps/s;
4b. graph  — VAE-NB, VAE-CP-f32, VAE-Poisson-cat and GMVAE-NB (one
             configuration per kernel family on a training path),
             VAE-NB-unfused, GMVAE-NB-full and VAE-NB-stream (streamed
             from the host, one graph per batch signature), trained
             for two epochs through ``train_config_level`` from the same
             seed, eagerly and through the graphs: the same launches, the
             parameters within 2e-5 of the largest |parameter|, the curves
             within 1e-6 relative, and both runs' steps/s;
4c. deferred — VAE-NB on phase 5's split with validation for three epochs
             with ``metrics_fetch="sync"`` and "deferred": the same curves
             (1e-6 relative), epochs trained, best epoch and epochs in the
             files of the run, ``best/`` and ``early_stopping/``;
4e. stream — the streaming path, each run into an emptied directory
             under ``build/``: (1) the headline counts through
             ``BatchPipeline`` (which must pick the CSR wire): the first
             three batches of epoch 0 materialized on the card equal, bit
             for bit, to K1's gather of the same rows from the staged
             int16 counts, and one training loss and its gradients on each
             within 1e-6 on both routes; the wire's capacity and bytes
             against dense int16, a copy of each from pinned memory, the
             overflow batches of an epoch; (2) VAE-NB-stream, the headline
             VAE-NB with ``data_placement="streaming"`` on phase 5's split
             for two epochs, ``metrics_fetch="deferred"`` run as sync;
             (3) GMVAE-NB-stream (10 clusters) likewise; both with a
             finite, rising ELBO, NB's K2 and K3's three kernels once a
             step (VAE-NB-stream's evaluations NB's float32 K2 besides once
             a batch) and no K1; (4) VAE-Bernoulli-noisy,
             ``noisy_preprocessing_methods=["normalise", "binarise"]``
             under ``data_placement="auto"`` (which streams), two epochs:
             a finite ELBO, the epochs' values drawn anew, no likelihood
             kernel; (5) VAE-NB-over-budget: 1,306,127 cells × 4,096 genes
             (10.70 GB as int16) for one epoch under "auto", which must
             stream, with peak device memory under the 8 GiB budget, then
             ``evaluate`` of its first 20,480 rows; for each run the
             steps/s and cells/s, the host's ms a batch to build and to
             place it, a replay's device ms and the device's busy share of
             the last epoch;
4f. mesh  — data parallel on a world of one NCCL rank (a ``FileStore``
             under ``build/``; the process group is destroyed when the
             phase ends): the headline VAE-NB and GMVAE-NB (10 clusters)
             for two epochs and VAE-NB-stream (phase 4e's split,
             ``data_placement="streaming"``) for one through
             ``train(number_of_devices=1)``, each beside the same run
             without a mesh: the lower bounds within 1e-6 relative, the
             same launches, NB's K2 and K3's three kernels once a step
             and K1 once a step and evaluation batch on the device path;
             a second mesh run of each, traced in epoch 2, holds NCCL's
             reduction kernels (``oneRankReduce`` on one rank) as many as
             the all-reduces counted there, ``collectives_per_step`` a
             training step and one an evaluation (epoch on the device
             path, batch streamed), no model-axis all-reduce, and the
             collectives of each kind; the steps/s with and without the
             mesh;
5. after   — the life of a model after training: the counts split 90/10
             into training and validation rows; VAE-NB and a GMVAE (10
             clusters) for each base family trained at the headline width
             for three epochs with the validation set and a log directory
             under ``build/``; the run's files, ``best/`` restored equal to
             the parameters of the best epoch bit for bit, ``evaluate`` on
             the validation set (through the pipeline: no K1) and
             ``sample`` of 2,048 cells; and on each
             restored GMVAE, for each validation minibatch, log p(x|z,y) over
             the K·S = 10 decoder groups and its gradients for h and the
             heads, weighted by q(y|x), through the grouped kernels with
             bf16 operands and in float32 (one launch of K4 and of each of
             K5's three kernels per batch and dtype: the grouped gradient
             kernel, the dh and dW products) against the flat kernels of
             the same dtype over the same rows with cycled targets;
5b. data   — the data engine: (a) the development set of the JAX
             package's golden tests, 1,000 rows kept at random and split
             0.9 at random, built in memory from
             ``create_development_data_set()`` (no HDF5 cache: the card's
             machine has no ``h5py``); its rows, values and labels against
             the reference's seeds on the host and staged on the card; K1
             and NB's K2/K3 at the golden runs' shapes (100 rows of 25
             genes, under one tile; decoder width 32; 300 cycled GMVAE
             rows) against their plain versions; the two golden
             configurations of ``tests/test_golden.py`` (VAE-NB, GMVAE-NB
             with 3 clusters) trained on the card: finite curves, NB's K2
             and K3's three kernels once per training step, K1 at least
             once, accuracies in [0, 1] and the last validation accuracy
             equal to a majority vote recomputed on the host; (b) the
             headline counts labelled with 10
             class names drawn from ``RandomState(2)``, one excluded, split
             0.9 at random (55,548 / 6,173 / 6,858 rows); GMVAE-NB (10
             clusters) trained for three epochs with the validation set and
             its per-epoch accuracy: accuracies finite in [0, 1], the last
             validation accuracy equal to q(y|x)'s argmax on the card
             with the majority vote recomputed on the host, ``evaluate``'s
             predicted labels equal to that vote's labels, NB's K2 and K3's
             three kernels once per training step, K1 at least once; the
             accuracy callback's seconds per epoch and the steps/s;
5c. analyses — the evaluation analyses of 5b (b)'s model on the card
             (``scvae_tpu_torch.analyses``), each held against the same
             function with ``device="cpu"`` on the same inputs: the status
             methods against the run (trained, a best model, the epochs,
             ``learning_curves`` equal to the loop's curves); ``evaluate``
             of the test set and of the training set's latent values;
             ``predict_labels`` with k-means (K = 10, mini-batch over the
             55,548 × 100 training latents, seed 0: the same partition on
             the CPU from the same seed, ARI ≥ 0.999, and the mini-batch
             fit's steps and inertia) and with "model";
             ``compute_clustering_metrics`` over the 6,858 × 2,048 test
             values (ARI and accuracies equal, AMI within 1e-12, the
             unsampled silhouette within 1e-6 relative) and the silhouette
             of the training latents at the 20,000-row sample (1e-6);
             summary statistics of the test values and latents, a
             2-component PCA of the training latents with the prior
             centroids' means and covariances, and an IncrementalPCA of
             the 2,048-gene test values (1e-6); ``analyse_results`` with
             "metrics" and "predictions", then "latent_values", into
             ``build/analyses``: each expected file written and its
             pickles loading; each part's seconds on the card;
5d. figures' computing parts — (a) the headline VAE-NB on phase 5's split
             for three epochs through ``train(intermediate_analyser=…)``
             (an analyser that records what it is given: the card's
             machine has no matplotlib): called at the JAX package's
             epochs (``log_spaced_indices(3)``: every epoch), the last
             epoch's 2,000 × 100 latent values equal to ``latent_means``
             of the stored parameters on the CPU (within the small step's
             bound), NB's K2 and K3's three kernels once per step and K1;
             (b) ICA of 5c's 6,858 test latents in float64: its first 20
             fixed-point steps against the CPU, the whole run (200 steps:
             it does not converge on these near-Gaussian latents) timed;
             t-SNE's P, PCA start and first gradient on a
             2,000-row sample of them against the CPU, then the whole
             descent there (KL(P ‖ Q) within 3%: the CPU's own moves by
             1.2% when the inputs move by a float32 step; 10-nearest-
             neighbour preservation within 0.02 of the CPU's); t-SNE of all 6,858
             test latents and of the 55,548 training latents on the card
             alone, their seconds, KL and preservation; (c) the distance
             matrix of 1,000 test latents (``torch.cdist``) against the
             CPU; each part's seconds on a line of its own.

Phase 3 also holds the grouped kernels K4/K5 of every base family, bf16
and float32 (h, W and da as three bf16 terms), against their plain
versions at the GMVAE's shapes (G = 10 groups of 2,048 rows, decoder width
256, and the cap G = 16), kernel by kernel, and NB's against the flat
kernels over the same 20,480 rows with cycled targets; it times each
grouped kernel beside the flat tensor-core kernels over the same rows.

Prints the kernels JSON line, the card line and, last, the ok JSON line.
Exits non-zero without a result when no CUDA device is present or the
package is missing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_CELLS, N_GENES, HIDDEN, LATENT, BATCH = 68_579, 2_048, 256, 100, 2_048
WIDE_HIDDEN = 1_024
EPOCHS = 2
CLUSTERS = 10  # GMVAE-NB: K·S·B = 20,480 decoder rows per step
# The trained configurations: (label, model, reconstruction distribution,
# reconstruction classes, Poisson mean of the nonzero counts, precision:
# None for the default, bf16 matmul inputs on the GPU).  The headline
# counts (Poisson(3) + 1) do not reach K = 30, so VAE-Poisson-cat trains on
# Poisson(30) + 1 counts at the same places, about 0.6 of them at or above
# K: otherwise its base head would never take a gradient.  VAE-NB-f32 is
# the headline VAE-NB with precision="float32", the JAX package's own
# choice on any backend but a TPU: the float32 K2/K3; VAE-CP-f32 is the
# headline VAE-CP likewise: the float32 K6/K7; VAE-Poisson-cat-f32 is
# VAE-Poisson-cat likewise: the categorised float32 K2/K3 at 32 heads.
TRAINED = (
    ("poisson", "vae", "poisson", 0, 3.0, None),
    ("zero-inflated poisson", "vae", "zero-inflated poisson", 0, 3.0, None),
    ("zero-inflated negative binomial", "vae",
     "zero-inflated negative binomial", 0, 3.0, None),
    ("constrained poisson", "vae", "constrained poisson", 0, 3.0, None),
    ("negative binomial", "vae", "negative binomial", 0, 3.0, None),
    ("VAE-NB-f32", "vae", "negative binomial", 0, 3.0, "float32"),
    ("VAE-CP-f32", "vae", "constrained poisson", 0, 3.0, "float32"),
    ("VAE-ZINB-cat", "config", "zero-inflated negative binomial", 10, 3.0,
     None),
    ("VAE-Poisson-cat", "vae", "poisson", 30, 30.0, None),
    ("VAE-Poisson-cat-f32", "vae", "poisson", 30, 30.0, "float32"),
    ("GMVAE-NB", "gmvae", "negative binomial", 0, 3.0, None),
)
# The categorised kernel checks: (base, K) with 14 and 32 heads.
CATEGORISED = (("zero-inflated negative binomial", 10), ("poisson", 30))
# The base families, which the grouped kernels take, and their cap on groups.
BASE_FAMILIES = ("poisson", "negative binomial", "zero-inflated poisson",
                 "zero-inflated negative binomial")
GROUP_CAP = 16
# Phase 4b: one configuration per kernel family on a training path (as
# TRAINED), trained eagerly and through the CUDA graphs from the same seed.
# A graph replays the eager step's kernels on the same inputs, so the two
# runs may differ only where a kernel's result depends on when it runs; the
# parameters are held to 2e-5 of the largest |parameter| (the small
# step's bound) and the curves to 1e-6 relative.
GRAPHED = (
    ("VAE-NB", "vae", "negative binomial", 0, 3.0, None, {}),
    ("VAE-CP-f32", "vae", "constrained poisson", 0, 3.0, "float32", {}),
    ("VAE-Poisson-cat", "vae", "poisson", 30, 30.0, None, {}),
    ("GMVAE-NB", "gmvae", "negative binomial", 0, 3.0, None, {}),
    # phase 4d's unfused path and full-covariance latent
    ("VAE-NB-unfused", "vae", "negative binomial", 0, 3.0, None,
     {"fused_likelihood": False}),
    ("GMVAE-NB-full", "gmvae", "negative binomial", 0, 3.0, None,
     {"latent_distribution": "full-covariance gaussian mixture"}),
    # phase 4e's path: streamed from the host, one graph per batch
    # signature (the "-stream" label selects it)
    ("VAE-NB-stream", "vae", "negative binomial", 0, 3.0, None, {}),
)
GRAPH_PARAM_RTOL = 2e-5
GRAPH_CURVE_RTOL = 1e-6
# Phase 4d: the model options and the rest of the distribution library,
# each trained through the API at the headline width for two epochs:
# (label, model, reconstruction distribution, classes, the data (see
# options_data), the constructor's other arguments, whether it trains on
# NB's fused kernels).  The batch indices are 4 batches drawn from
# RandomState(3); the LFM's decoder input is z, 4 one-hots and the count
# sum: width 105, which the heads kernels pad to 112.  VAE-Poisson-cat-40
# has 42 heads, over the fused cap of 32, and trains unfused on phase 4's
# Poisson(30) + 1 counts (about 6% of the nonzero ones reach K = 40).
N_BATCHES = 4
MVG_GENES = 128
OPTIONS = (
    ("VAE-NB-unfused", "vae", "negative binomial", 0, "counts",
     {"fused_likelihood": False}, False),
    ("VAE-NB-batch", "vae", "negative binomial", 0, "batches",
     {"batch_correction": True, "number_of_batches": N_BATCHES,
      "count_sum": True}, True),
    ("VAE-NB-LFM", "vae", "negative binomial", 0, "batches",
     {"inference_architecture": "LFM", "generative_architecture": "LFM",
      "batch_correction": True, "number_of_batches": N_BATCHES,
      "count_sum": True}, True),
    ("GMVAE-NB-full", "gmvae", "negative binomial", 0, "counts",
     {"latent_distribution": "full-covariance gaussian mixture"}, True),
    ("VAE-Poisson-cat-40", "vae", "poisson", 40, "counts30", {}, False),
    ("VAE-Bernoulli", "vae", "bernoulli", 0, "binarised", {}, False),
    ("VAE-Gaussian", "vae", "gaussian", 0, "counts", {}, False),
    ("VAE-LogNormal", "vae", "log-normal", 0, "counts", {}, False),
    ("VAE-Lomax", "vae", "lomax", 0, "counts", {}, False),
    ("VAE-EMG", "vae", "exponentially_modified_gaussian", 0, "counts", {},
     False),
    ("VAE-Gamma", "vae", "gamma", 0, "counts_plus_one", {}, False),
    ("VAE-GaussianMixture", "vae", "gaussian mixture", 0, "counts", {},
     False),
    ("VAE-MVG-128", "vae", "multivariate gaussian", 0, "first_genes", {},
     False),
)
# Decoder widths of NB's K2/K3 on the LFM's path: z alone, z and the count
# sum, z, 4 batch one-hots and the count sum.
LFM_WIDTHS = (LATENT, LATENT + 1, LATENT + N_BATCHES + 1)
# One training loss and its gradients at the headline shapes, fused against
# unfused on the card: the loss within phase 3's bf16 backward tolerance,
# relative; in float32 every gradient within it too, of the largest
# |gradient|.  With bf16 matmul inputs a dense kernel's gradient passes
# back through the cast to bf16 (JAX's rounding) and is a bf16 number, so
# where the two paths' float32 sums differ a gradient value v moves by a
# whole bf16 step, v·2^-8 (run 1: 0.0625 of a largest 69, 9.1e-4): there
# the whole gradient is held in norm, ‖Δ‖/‖g‖, to the bound of the CPU
# bf16 tests against JAX (tests/test_torch_vae.py).
FUSED_UNFUSED_RTOL = 4e-4
BF16_GRADIENT_NORM_RTOL = 5e-3
# steps/s of epoch 2 by configuration label (phase 4 and 4d)
RATES: dict[str, float] = {}
# Phase 5: epochs, validation share, cells sampled, the runs' directory.
AFTER_EPOCHS = 3
VALIDATION_SHARE = 0.1
SAMPLES = 2_048
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SLICE_DIRECTORY = os.path.join(BUILD, "slice_training")
AFTER_DIRECTORY = os.path.join(BUILD, "after_training")
DEFERRED_DIRECTORY = os.path.join(BUILD, "deferred_training")
OPTIONS_DIRECTORY = os.path.join(BUILD, "options_training")
# Phase 4e: streaming.  The over-budget set: the cell count of the 10x
# Genomics 1.3M-cell mouse-brain set at twice the headline's genes, counts
# Poisson(3) + 1 at density 0.07 (286 stored entries a row); its dense int16
# form, 10.70 GB, is over the port's 8 GiB device budget.
STREAM_DIRECTORY = os.path.join(BUILD, "stream_training")
OVER_CELLS, OVER_GENES = 1_306_127, 4_096
STREAM_CHECKED_BATCHES = 3
OVER_EVALUATED = 20_480
# One streamed loss against the device route's on the same batch: the
# device route's NB row constants are staged once, the streamed route's
# summed in the step (the same float32 sums, maybe in another order).
STREAM_LOSS_RTOL = 1e-6
STREAM_GRADIENT_RTOL = 1e-6

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# Tolerances of the kernel checks against the plain versions: the max abs
# error over the largest |value| of the plain output.  Forward: float32 sums
# taken in another order (reads ~2e-7).  Backward with bf16 rounding: also da
# values that the other order rounds to a neighbouring bf16 value (NB's dW
# reads ~1.3e-4; a kernel that leaves da or h unrounded reads 1.1e-3 to
# 2.6e-3).  Float32 backward against autograd, the constrained Poisson's
# backward (which never rounds) and the small step on the GPU against the
# CPU (gradients over the largest gradient of the model): summation order
# alone (reads up to 2e-6).  The constrained Poisson's bf16 kernels split W
# and da into two bf16 terms each, which leave at most 2^-16 of each value:
# the plain versions of that design read up to 4.4e-6 of the largest dh or
# dW against the float32 plain versions (tools/cp_split_precision.py); its
# float32 kernels split h, W and da into three, read up to 2.6e-6
# (tools/f32_split_precision.py --families cp).
FORWARD_RTOL = 2e-5
BACKWARD_RTOL = 4e-4
AUTOGRAD_RTOL = 2e-5
# The bf16 backward's three tensor-core kernels, each on its own: the dh and
# dW products against the plain products of the kernel's own da (summation
# order alone), and the gradient kernel's bf16(da) within one bf16 step of
# the plain bf16(da) or within PRODUCT_RTOL of its largest |value|, with at
# most MAX_FLIP_SHARE of the values flipped to the neighbouring bf16 value
# (a kernel that rounds otherwise, or not at all, flips about half).
PRODUCT_RTOL = 2e-5
MAX_FLIP_SHARE = 1e-3

CSRC = "scvae_tpu_torch/ops/csrc/"
SOURCES = {
    "gather": CSRC + "gather.cu",
    "count": CSRC + "count_likelihood_tc.cu",
    "product": CSRC + "tc_product.cu",
    "cp": CSRC + "cp_likelihood_tc.cu",
    "cat_tc": CSRC + "categorised_likelihood_tc.cu",
    "grouped_tc": CSRC + "grouped_likelihood_tc.cu",
}
REPLACES = {
    "gather_rows": "scvae_tpu/ops/gather.py:223",
    "forward": "scvae_tpu/ops/fused_likelihood.py:627",
    "backward": "scvae_tpu/ops/fused_likelihood.py:714",
    "cp_forward": "scvae_tpu/ops/fused_likelihood.py:1356",
    "cp_backward": "scvae_tpu/ops/fused_likelihood.py:1417",
    "grouped_forward": "scvae_tpu/ops/fused_likelihood.py:964",
    "grouped_backward": "scvae_tpu/ops/fused_likelihood.py:1041",
}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_counts(n_cells: int, n_genes: int, density: float = 0.07,
                mean: float = 3.0):
    """Synthetic sparse counts with PBMC-like sparsity (~93% zeros), made as
    ``bench.py`` makes them (seed 0): Poisson(``mean``) + 1 where nonzero."""
    import scipy.sparse

    rng_np = np.random.RandomState(0)
    n_nonzero_per_row = max(1, int(n_genes * density))
    rows = np.repeat(np.arange(n_cells), n_nonzero_per_row)
    cols = rng_np.randint(0, n_genes, size=rows.shape[0])
    vals = rng_np.poisson(mean, size=rows.shape[0]).astype(np.float32) + 1.0
    return scipy.sparse.csr_matrix(
        (vals, (rows, cols)), shape=(n_cells, n_genes)
    )


# Cycles of the spin that holds the device before each timed launch, so
# that the host has queued the whole call when the device reaches it (about
# 6 ms at the H100's boost clock; a call's host dispatch takes far less).
HOLD_CYCLES = 10_000_000


def time_ms(fn, reps=25, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache flushed before each launch when ``flush`` is given.
    A spin kernel holds the device while the host queues the call, so the
    events time the device's work and not the gaps of host dispatch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, rtol, scale=None) -> float:
    """Max abs error of ``got`` against ``want``; fails above ``rtol`` times
    ``scale`` (by default the largest |value| of ``want``)."""
    err = max_err(got, want)
    if scale is None:
        scale = float(want.float().abs().max())
    log(f"check {name}: max abs error {err:.3g}, "
        f"{err / scale if scale else float('nan'):.3g} of {scale:.4g} "
        f"(limit {rtol:g})")
    if not np.isfinite(err) or err > rtol * scale:
        raise AssertionError(
            f"{name}: max abs error {err} exceeds {rtol} x {scale}"
        )
    return err


def check_bf16_steps(name, got, want) -> float:
    """Max abs error of bf16 ``got`` against bf16 ``want``; fails where a
    value is more than one bf16 step and PRODUCT_RTOL of the largest |want|
    away, or where more than MAX_FLIP_SHARE of the values differ."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    _, exponent = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(diff), exponent - 8)
    floor = PRODUCT_RTOL * float(want.abs().max())
    beyond = int((diff > torch.clamp(step, min=floor)).sum())
    flips = int((diff > 0).sum())
    log(f"check {name}: {flips} of {diff.numel()} values one bf16 step "
        f"away ({flips / diff.numel():.3g}, limit {MAX_FLIP_SHARE:g}), "
        f"{beyond} further")
    if beyond or flips > MAX_FLIP_SHARE * diff.numel():
        raise AssertionError(f"{name}: {flips} flips, {beyond} values further "
                             "than one bf16 step")
    return float(diff.max())


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def head_weights(gen, n_heads, hidden, f, dev):
    """Glorot-uniform head kernels and small random biases."""
    limit = (6.0 / (hidden + f)) ** 0.5
    weights = [(torch.rand(hidden, f, generator=gen, device=dev) * 2 - 1) * limit
               for _ in range(n_heads)]
    biases = [0.1 * torch.randn(f, generator=gen, device=dev)
              for _ in range(n_heads)]
    return weights, biases


def _cut(tensors, cols):
    return [x[..., :cols].contiguous() for x in tensors]


def check_gather(counts_dev, idx, flush):
    """K1 — row gather: bit-exact with index_select + cast at the headline
    shapes, a ragged F, a float32 source and repeated indices, to bf16 and
    to float32 (the plan's 16-byte units), and for the (N, 1) count sums
    that VAE-CP's step gathers (its element path); then its time against
    ``index_select`` + ``.to``."""
    from scvae_tpu_torch import ops

    bf16 = torch.bfloat16
    m, f = idx.shape[0], counts_dev.shape[1]
    x = ops.gather_rows(counts_dev, idx, bf16)
    x_ref = ops.reference_gather(counts_dev, idx, bf16)
    f32_src = counts_dev[:4096].float()
    sums = counts_dev.float().sum(1, keepdim=True)
    repeated = idx[:m // 2].repeat(2)
    cases = [(x, x_ref)] + [
        (ops.gather_rows(src, rows, dtype), ops.reference_gather(src, rows,
                                                                 dtype))
        for src, rows in ((counts_dev, idx), (counts_dev, repeated),
                          (counts_dev[:, :2000].contiguous(), idx),
                          (f32_src, idx % 4096), (sums, idx))
        for dtype in (bf16, torch.float32)
    ]
    for got, want in cases:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError("gather_rows is not bit-exact")
    log(f"check gather_rows: {len(cases)} cases bit-exact")
    gather_bytes = m * f * (counts_dev.element_size() + 2) + m * 4
    t_bound, by = bound(gather_bytes, 0.0, BF16_FLOPS)
    result = {
        "max_abs_err": max_err(x, x_ref),
        "ms": time_ms(lambda: ops.gather_rows(counts_dev, idx, bf16),
                      flush=flush, reps=50),
        "plain_ms": time_ms(lambda: ops.reference_gather(
            counts_dev, idx, bf16), flush=flush),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": time_ms(lambda: torch.index_select(
            counts_dev, 0, idx).to(bf16), flush=flush),
    }
    print(f"gather B={m} F={f} int16 -> bf16: {result['ms']:.5f} ms; "
          f"index_select + .to {result['library_ms']:.5f}; bound "
          f"{t_bound:.5f} ({by}); count sums (F=1, element path) "
          f"{time_ms(lambda: ops.gather_rows(sums, idx), flush=flush):.5f}",
          flush=True)
    return x, result


def check_family(name, h, g, x, gen, flush):
    """K2 and both K3 passes of one base family: the forward (main path with
    bf16 inputs and the staged lgamma constant, ragged F, float32 inputs with
    the in-kernel constant, float32 targets; float32 on the main path's
    inputs against its split design's plain version too), the bf16 backward
    against the plain backward with the same rounding (and ragged F), and
    the float32 backward against autograd through the plain forward; then
    the bf16 and the float32 kernels one by one (count_kernel_times)."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import fused_likelihood as fl

    bf16 = torch.bfloat16
    fam = ops.FAMILIES[name]
    k = len(fam.heads)
    m, hidden = h.shape
    f = x.shape[1]
    ws, bs = head_weights(gen, k, hidden, f, h.device)
    ragged = (_cut(ws, 2000), _cut(bs, 2000), x[:, :2000].contiguous())
    full = (ws, bs, x)

    fwd_cases = [(full, bf16, False), (ragged, bf16, False),
                 ((ws, bs, x), None, True), ((ws, bs, x.float()), bf16, True),
                 (ragged, None, False)]
    for i, ((w_, b_, t), cdt, const) in enumerate(fwd_cases):
        got = ops.fused_forward(name, h, w_, b_, t, compute_dtype=cdt,
                                include_lgamma_const=const)
        want = ops.reference_forward(name, h, w_, b_, t, compute_dtype=cdt,
                                     include_lgamma_const=const)
        err = check_close(f"{fam.prefix}_forward F={t.shape[1]} {cdt} "
                          f"t={t.dtype} const={const}", got, want,
                          FORWARD_RTOL)
        if i == 0:  # the main path's case
            fwd_err = err

    parts = ["dh"] + [f"{p}_{head}" for head in fam.heads for p in ("dW", "db")]
    for w_, b_, t in (full, ragged):
        got = ops.fused_backward(name, g, h, w_, b_, t, compute_dtype=bf16)
        want = ops.reference_backward(name, g, h, w_, b_, t,
                                      compute_dtype=bf16)
        for part, a, b in zip(parts, got, want):
            check_close(f"{fam.prefix}_backward {part} F={t.shape[1]}", a, b,
                        BACKWARD_RTOL)
    leaves = [a.clone().requires_grad_(True) for a in (h, *ws, *bs)]
    ll = ops.reference_forward(name, leaves[0], leaves[1:1 + k],
                               leaves[1 + k:], x, include_lgamma_const=False)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)  # dh, dWs, dbs
    got = ops.fused_backward(name, g, h, ws, bs, x)  # dh, dW_0, db_0, …
    order = [0] + [i for j in range(k) for i in (1 + j, 1 + k + j)]
    for part, a, i in zip(parts, got, order):
        check_close(f"{fam.prefix}_backward float32 {part} vs autograd", a,
                    want[i], AUTOGRAD_RTOL)

    # the float32 forward on the main path's inputs, against the plain
    # version of its split design and the float32 plain version
    fwd_args = (name, h, ws, bs, x)
    out = ops.fused_forward(*fwd_args, include_lgamma_const=False)
    f32_fwd_err = check_close(
        f"{fam.prefix}_forward_float32 M={m}", out,
        fl.reference_f32_tc_forward(*fwd_args, include_lgamma_const=False),
        FORWARD_RTOL)
    check_close(f"{fam.prefix}_forward_float32 M={m} vs float32 plain", out,
                ops.reference_forward(*fwd_args, include_lgamma_const=False),
                FORWARD_RTOL)

    results = count_kernel_times(name, h, g, ws, bs, x, flush, fwd_err,
                                 tag=fam.prefix)
    results.update(count_kernel_times(name, h, g, ws, bs, x, flush,
                                      f32_fwd_err, tag=fam.prefix,
                                      float32=True))
    return results


def forced_splits(grad, splits, promote=False):
    """``grad`` with both products planned by ``fl.tc_splits`` on a card
    that holds any number of clusters of up to ``splits`` blocks and none
    larger, sums promoted or not as asked (for a sweep: a deep unpromoted
    split may read above the checks' limits)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    admits = {s: (1 << 30 if s <= splits else 0)
              for s in range(1, fl.TC_MAX_SPLITS + 1)}
    plan = dict(grad.plan)
    for key, depth in (("dh_splits", grad.da.shape[1]),
                       ("dw_splits", grad.da.shape[0])):
        plan[key] = (*fl.tc_splits(1, depth, admits), promote)
    return dataclasses.replace(grad, plan=plan)


def check_split_da(tag, grad, plain) -> float:
    """The float32 gradient kernel's scratch against its plain version: the
    entries' split of h and W bit for bit, the copies of each term of da
    equal, its first term within one bf16 step of the plain one, the sum of
    its terms within PRODUCT_RTOL (returns that error)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    m = grad.da.shape[0]
    if not (torch.equal(grad.h, plain.h) and torch.equal(grad.w, plain.w)):
        raise AssertionError(f"{tag} float32: the split of h and W differs "
                             "from its plain version")
    got, want = (z.da.reshape(m, len(fl.SPLIT_PAIRS), -1)
                 for z in (grad, plain))
    # slot p holds da's term i of pair p; the first pair of term i is (i, 0)
    first = [fl.SPLIT_PAIRS.index((i, 0)) for i in range(fl.SPLIT_TERMS)]
    for p, (i, _) in enumerate(fl.SPLIT_PAIRS):
        if not torch.equal(got[:, p], got[:, first[i]]):
            raise AssertionError(f"{tag}_backward_gradient_float32: the "
                                 f"copies of da's term {i} differ")
    check_bf16_steps(f"{tag}_backward_gradient_float32 da_0 M={m}",
                     got[:, 0], want[:, 0])
    return check_close(
        f"{tag}_backward_gradient_float32 sum of da's terms M={m}",
        sum(got[:, p].float() for p in first),
        sum(want[:, p].float() for p in first), PRODUCT_RTOL)


def dw_yardstick(grad, h32=None, da32=None):
    """The library yardstick of a dW product: one ``torch.mm`` of the
    product alone (dW only, db not included).  bf16: hᵀ·da on the kernel's
    own bf16 operands (the product's depth and width, pairs of terms
    included) into float32.  float32: the float32 h's transpose times the
    function's float32 da (``da32``, else the sum of the scratch's terms)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    if h32 is None:
        da = grad.da.reshape(grad.h.shape[0], -1)
        return lambda: torch.mm(grad.h.T, da, out_dtype=torch.float32)
    if da32 is None:
        first = [fl.SPLIT_PAIRS.index((i, 0)) for i in range(fl.SPLIT_TERMS)]
        terms = grad.da.reshape(h32.shape[0], len(fl.SPLIT_PAIRS), -1)
        da32 = sum(terms[:, p].float() for p in first)
    return lambda: torch.mm(h32.T, da32)


def count_kernel_times(name, h, g, ws, bs, x, flush, fwd_err, tag, reps=25,
                       float32=False):
    """The K2 and K3 kernels of base family ``name`` on the main path's
    tensor-core kernels, bf16, or with ``float32`` h, W and da as
    ``fl.SPLIT_TERMS`` bf16 terms (counters with the "_float32" suffix):
    the backward's three kernels (the gradient kernel, which writes da's
    bf16 terms and their column sums per row tile; the dh product and the
    dW/db pass, which read them) each held against its plain version on the
    same inputs, the products bit for bit over two runs; then each kernel,
    the forward with ``fwd_err`` from its check, timed with its own bound.
    bf16 also prints the backward as a whole, the yardstick (a bf16
    ``torch.matmul`` of the same head products alone) and a timing sweep
    over the products' depth splits; float32 the public calls beside the
    float32 plain versions and the split of h and W in torch ops."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import fused_likelihood as fl

    bf16 = torch.bfloat16
    k = len(ws)
    (m, hidden), (m_t, f) = h.shape, x.shape
    timed = dict(flush=flush, reps=reps)
    cdt, sfx = (None, "_float32") if float32 else (bf16, "")
    fwd_args = (name, h, ws, bs, x)
    bwd_args = (name, g, h, ws, bs, x)
    if float32:
        gradient = fl.f32_tc_gradient
        plain_gradient = fl.reference_f32_tc_gradient

        def plain_forward():
            return fl.reference_f32_tc_forward(*fwd_args,
                                               include_lgamma_const=False)
    else:
        gradient, plain_gradient = fl.tc_gradient, fl.reference_tc_gradient

        def plain_forward():
            return ops.reference_forward(*fwd_args, compute_dtype=bf16,
                                         include_lgamma_const=False)

    grad = gradient(*bwd_args)
    plain = plain_gradient(*bwd_args)
    if float32:
        grad_err = check_split_da(tag, grad, plain)
    else:
        grad_err = check_bf16_steps(f"{tag}_backward_gradient bf16(da) M={m}",
                                    grad.da, plain.da)
    check_close(f"{tag}_backward_gradient{sfx} db row-tile sums M={m}",
                grad.db_parts, plain.db_parts, PRODUCT_RTOL)
    dh = fl.tc_dh(grad)
    dh_err = check_close(f"{tag}_backward_dh{sfx} of the kernel's da M={m}",
                         dh, fl.reference_tc_dh(grad), PRODUCT_RTOL)
    dws = fl.tc_dw(grad)
    dw_err = max(check_close(f"{tag}_backward_dw{sfx} [{i}] of the kernel's "
                             f"da M={m}", a, b, PRODUCT_RTOL)
                 for i, (a, b) in enumerate(zip(
                     dws, fl.reference_tc_dw(grad), strict=True)))
    again = (fl.tc_dh(grad), *fl.tc_dw(grad))
    if not all(torch.equal(a, b) for a, b in zip((dh, *dws), again)):
        raise AssertionError(f"{tag}{sfx} products differ between two runs")

    # One product of the heads: 2·NH·M·H·F operations, counted once however
    # many pairs of terms the float32 design multiplies.  Bytes: h and the
    # heads arrive in float32, t as it arrives (bf16), and every output is
    # float32.  bf16: da is bf16 as the kernels pass it, and the products
    # read bf16 h and W.  float32: the function's da is float32, counted
    # once at 4 B an element (not as its bf16 terms, nor the scratch's
    # copies per pair), and the products' h and W are the float32 ones.
    product = 2 * k * m * hidden * f
    head_bytes = k * (hidden * f + f) * 4
    in_bytes = m * hidden * 4 + head_bytes + m_t * f * x.element_size()
    db_bytes = grad.db_parts.numel() * 4
    if float32:
        da_bytes, h_bytes, w_bytes = m * k * f * 4, m * hidden * 4, (
            k * hidden * f * 4)
    else:
        da_bytes, h_bytes, w_bytes = (grad.da.numel() * 2,
                                      grad.h.numel() * 2, grad.w.numel() * 2)
    w2 = grad.w.reshape(grad.w.shape[0], -1)
    kernels = {  # fn, plain, library, err, bytes
        "forward": (
            lambda: ops.fused_forward(*fwd_args, compute_dtype=cdt,
                                      include_lgamma_const=False),
            plain_forward, None, fwd_err, in_bytes + m * 4),
        "backward_gradient": (
            lambda: gradient(*bwd_args), lambda: plain_gradient(*bwd_args),
            None, grad_err, in_bytes + m * 4 + da_bytes + db_bytes),
        "backward_dh": (
            lambda: fl.tc_dh(grad), lambda: fl.reference_tc_dh(grad),
            lambda: torch.mm(grad.da, w2.T, out_dtype=torch.float32),
            dh_err, da_bytes + w_bytes + m * hidden * 4),
        "backward_dw": (
            lambda: fl.tc_dw(grad), lambda: fl.reference_tc_dw(grad),
            dw_yardstick(grad, h if float32 else None),
            dw_err, h_bytes + da_bytes + db_bytes + head_bytes),
    }
    results = {}
    for kernel, (fn, plain_fn, library, err, nbytes) in kernels.items():
        t_bound, by = bound(nbytes, product, BF16_FLOPS)
        library_ms = None
        if library is not None:
            try:  # torch.mm with a float32 output from bf16 operands
                library_ms = time_ms(library, **timed)
            except (RuntimeError, TypeError) as err_:
                log(f"library call for {tag}_{kernel}{sfx} unavailable: "
                    f"{err_}")
        results[f"{tag}_{kernel}{sfx}"] = {
            "max_abs_err": err, "ms": time_ms(fn, **timed),
            "plain_ms": time_ms(plain_fn, **timed),
            "bound_ms": t_bound, "bound_by": by, "library_ms": library_ms,
        }
    parts = sum(results[f"{tag}_{kernel}{sfx}"]["ms"]
                for kernel in ("backward_gradient", "backward_dh",
                               "backward_dw"))
    if float32:
        public = {
            "fused_forward": (
                lambda: ops.fused_forward(*fwd_args,
                                          include_lgamma_const=False),
                lambda: ops.reference_forward(*fwd_args,
                                              include_lgamma_const=False)),
            "fused_backward": (lambda: ops.fused_backward(*bwd_args),
                               lambda: ops.reference_backward(*bwd_args)),
        }
        print(f"float32 {tag} M={m}: backward kernels {parts:.4f} ms; public "
              "calls against the float32 plain versions: " + "; ".join(
                  f"{label} {time_ms(fn, **timed):.4f} ms (float32 plain "
                  f"{time_ms(plain_fn, **timed):.4f} ms)"
                  for label, (fn, plain_fn) in public.items())
              + "; the split of h and W in torch ops (the plain version of "
              "the entries' split_pack_kernel) "
              f"{time_ms(lambda: fl._f32_tc_operands(h, ws), **timed):.4f} "
              "ms", flush=True)
        return results
    whole_bound, whole_by = bound(in_bytes + m * 4 + m * hidden * 4
                                  + head_bytes, 3 * product, BF16_FLOPS)
    whole = time_ms(lambda: ops.fused_backward(name, g, h, ws, bs, x,
                                               compute_dtype=bf16), **timed)
    print(f"backward {tag} M={m}: gradient + dh + dW kernels {parts:.4f} ms; "
          f"fused_backward with its operand copies {whole:.4f} ms; bound "
          f"{whole_bound:.5f} ms ({whole_by})", flush=True)

    products = {"forward h W": lambda: grad.h @ w2,
                "dh da W^T": lambda: grad.da @ w2.T,
                "dW h^T da": lambda: grad.h.T @ grad.da}
    print(f"yardstick {tag} M={m}: bf16 torch.matmul of the head products "
          "alone, " + ", ".join(f"{label} {time_ms(fn, **timed):.4f} ms"
                                for label, fn in products.items()),
          flush=True)
    sweep = []
    for splits in (1, 2, 3, 4, 6, 8):
        swept = forced_splits(grad, splits)
        sweep.append(
            f"{splits} splits (dh {swept.plan['dh_splits'][:2]}, dW "
            f"{swept.plan['dw_splits'][:2]}): dh product "
            f"{time_ms(lambda: fl.tc_dh(swept), **timed):.4f}, dW "
            f"{time_ms(lambda: fl.tc_dw(swept), **timed):.4f}")
    print(f"sweep {tag} M={m} (ms; planned dh {grad.plan['dh_splits']}, dW "
          f"{grad.plan['dw_splits']}): " + "; ".join(sweep), flush=True)
    return results


def check_cp(h, g, x, gen, flush):
    """K6 and K7 of the constrained Poisson.  The training path's bf16
    instance (h a bf16 tensor against float32 W, split into bf16 terms on
    the tensor cores): the forward's ll, lse and partials per gene tile
    (ragged F, float32 targets) against its plain version and within
    FORWARD_RTOL of the float32 plain version, lse bit for bit over two
    runs; the backward kernel by kernel (the gradient kernel's da terms and
    row-tile sums, the dh and dW products of its scratch, bit for bit over
    two runs) and as a whole within AUTOGRAD_RTOL of the float32 plain
    backward.  The float32 instance (VAE-CP-f32's: float32 h, and h, W and
    da as three bf16 terms on the same kernels) likewise against its split
    plain versions, and within FORWARD_RTOL / AUTOGRAD_RTOL of the float32
    plain versions and autograd.  Then their times, the float32 dh product
    beside torch.mm of the same float32 da and W^T."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import fused_likelihood as fl

    m, hidden = h.shape
    f = x.shape[1]
    (w,), (b,) = head_weights(gen, 1, hidden, f, h.device)
    hb = h.to(torch.bfloat16)
    hv = hb.float()
    n = x.float().sum(-1)  # the batch rows' count sums
    xr = x[:, :2000].contiguous()
    full = (hb, w, b, x, n)
    ragged = (hb, w[:, :2000].contiguous(), b[:2000].contiguous(), xr,
              xr.float().sum(-1))
    for args in (full, ragged, (hb, w, b, x.float(), n)):
        ll, lse, part = fl.cp_tc_forward(*args)
        ll_p, lse_p, part_p = fl.reference_cp_tc_forward(*args)
        ll32, lse32 = ops.reference_cp_forward(hv, *args[1:])
        label = f"F={args[3].shape[1]} t={args[3].dtype}"
        err = check_close(f"cp_forward ll {label}", ll, ll_p, FORWARD_RTOL)
        check_close(f"cp_forward lse {label}", lse, lse_p, FORWARD_RTOL)
        for q, part_name in enumerate(("max", "sumexp", "ll", "sum t")):
            check_close(f"cp_forward partials {part_name} {label}", part[q],
                        part_p[q], FORWARD_RTOL)
        check_close(f"cp_forward ll {label} vs float32 plain", ll, ll32,
                    FORWARD_RTOL)
        check_close(f"cp_forward lse {label} vs float32 plain", lse, lse32,
                    FORWARD_RTOL)
        if args is full:
            fwd_err, lse_main = err, lse
    if not torch.equal(fl.cp_tc_forward(*full)[1], lse_main):
        raise AssertionError("cp_forward: lse differs between two runs")
    # the whole bf16 backward against the float32 plain backward, which
    # multiplies the unrounded W and da
    for args in (full, ragged):
        hh, w_, b_, t, n_ = args
        _, lse = ops.cp_forward(*args)
        _, lse32 = ops.reference_cp_forward(hv, w_, b_, t, n_)
        got = ops.cp_backward(g, hh, w_, b_, t, lse)
        want = (ops.reference_cp_dh(g, hv, w_, b_, t, lse32),
                *ops.reference_cp_dw(g, hv, w_, b_, t, lse32))
        for part_name, a, b_ref in zip(("dh", "dW", "db"), got, want,
                                       strict=True):
            check_close(f"cp_backward {part_name} F={t.shape[1]} vs float32 "
                        "plain", a, b_ref, AUTOGRAD_RTOL)
    # kernel by kernel on the main path's inputs: the gradient kernel's da_0
    # within one bf16 step of the plain da_0 from the same lse, da_0 + da_1
    # and the row-tile sums; the products of its own scratch
    grad = fl.cp_tc_gradient(g, hb, w, b, x, lse_main)
    plain = fl.reference_cp_tc_gradient(g, hb, w, b, x, lse_main)
    got, want = (z.da.reshape(m, len(fl.CP_TERM_PAIRS), -1)
                 for z in (grad, plain))
    if not torch.equal(got[:, 0], got[:, 1]):
        raise AssertionError("cp_backward_gradient: the copies of da_0 differ")
    check_bf16_steps("cp_backward_gradient da_0", got[:, 0], want[:, 0])
    grad_err = check_close("cp_backward_gradient da_0 + da_1",
                           got[:, 0].float() + got[:, 2].float(),
                           want[:, 0].float() + want[:, 2].float(),
                           PRODUCT_RTOL)
    check_close("cp_backward_gradient db row-tile sums", grad.db_parts,
                plain.db_parts, PRODUCT_RTOL)
    dh = fl.tc_dh(grad)
    dh_err = check_close("cp_backward_dh of the kernel's da terms", dh,
                         fl.reference_tc_dh(grad), PRODUCT_RTOL)
    dw = fl.tc_dw(grad)
    dw_err = max(check_close(f"cp_backward_dw [{i}] of the kernel's da terms",
                             a, b_ref, PRODUCT_RTOL)
                 for i, (a, b_ref) in enumerate(zip(
                     dw, fl.reference_tc_dw(grad), strict=True)))
    again = (fl.tc_dh(grad), *fl.tc_dw(grad))
    if not all(torch.equal(a, b_) for a, b_ in zip((dh, *dw), again)):
        raise AssertionError("cp_backward products differ between two runs")

    # the float32 instance: float32 h (not bf16 values, so that h's later
    # terms are not zero), h, W and da as three bf16 terms each on the same
    # kernels.  The forward against its split plain version (ll, lse,
    # partials; ragged F, float32 targets) and within FORWARD_RTOL of the
    # float32 plain version, lse bit for bit over two runs; the public
    # backward within AUTOGRAD_RTOL of the float32 plain backward and of
    # autograd through the float32 plain forward; then kernel by kernel on
    # the main path's inputs: the entries' split of h and W bit for bit,
    # da's terms (check_split_da) and row-tile sums against the split plain
    # version from the same lse, the dh and dW products of the kernel's own
    # scratch against the plain products, bit for bit over two runs.
    f32_full = (h, w, b, x, n)
    f32_ragged = (h, *ragged[1:])
    for args in (f32_full, f32_ragged, (h, w, b, x.float(), n)):
        ll, lse, part = fl.cp_f32_tc_forward(*args)
        ll_p, lse_p, part_p = fl.reference_cp_f32_tc_forward(*args)
        ll32, lse32 = ops.reference_cp_forward(*args)
        label = f"F={args[3].shape[1]} t={args[3].dtype}"
        err = check_close(f"cp_forward_float32 ll {label}", ll, ll_p,
                          FORWARD_RTOL)
        check_close(f"cp_forward_float32 lse {label}", lse, lse_p,
                    FORWARD_RTOL)
        for q, part_name in enumerate(("max", "sumexp", "ll", "sum t")):
            check_close(f"cp_forward_float32 partials {part_name} {label}",
                        part[q], part_p[q], FORWARD_RTOL)
        check_close(f"cp_forward_float32 ll {label} vs float32 plain", ll,
                    ll32, FORWARD_RTOL)
        check_close(f"cp_forward_float32 lse {label} vs float32 plain", lse,
                    lse32, FORWARD_RTOL)
        if args is f32_full:
            f32_fwd_err, lse_f32 = err, lse
    if not torch.equal(fl.cp_f32_tc_forward(*f32_full)[1], lse_f32):
        raise AssertionError("cp_forward_float32: lse differs between two "
                             "runs")
    for args in (f32_full, f32_ragged):
        hh, w_, b_, t, n_ = args
        _, lse = ops.cp_forward(*args)
        _, lse32 = ops.reference_cp_forward(*args)
        got = ops.cp_backward(g, hh, w_, b_, t, lse)
        want = (ops.reference_cp_dh(g, hh, w_, b_, t, lse32),
                *ops.reference_cp_dw(g, hh, w_, b_, t, lse32))
        for part_name, a, b_ref in zip(("dh", "dW", "db"), got, want,
                                       strict=True):
            check_close(f"cp_backward float32 {part_name} F={t.shape[1]} vs "
                        "float32 plain", a, b_ref, AUTOGRAD_RTOL)
    leaves = [a.clone().requires_grad_(True) for a in (h, w, b)]
    ll, _ = ops.reference_cp_forward(*leaves, x, n)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)
    got = ops.cp_backward(g, h, w, b, x, lse_f32)
    for part_name, a, b_ref in zip(("dh", "dW", "db"), got, want,
                                   strict=True):
        check_close(f"cp_backward float32 {part_name} vs autograd", a, b_ref,
                    AUTOGRAD_RTOL)
    bwd32 = (g, h, w, b, x, lse_f32)
    grad32 = fl.cp_f32_tc_gradient(*bwd32)
    plain32 = fl.reference_cp_f32_tc_gradient(*bwd32)
    grad32_err = check_split_da("cp", grad32, plain32)
    check_close("cp_backward_gradient_float32 db row-tile sums",
                grad32.db_parts, plain32.db_parts, PRODUCT_RTOL)
    del plain32
    dh32 = fl.tc_dh(grad32)
    dh32_err = check_close("cp_backward_dh_float32 of the kernel's da", dh32,
                           fl.reference_tc_dh(grad32), PRODUCT_RTOL)
    dw32 = fl.tc_dw(grad32)
    dw32_err = max(check_close(f"cp_backward_dw_float32 [{i}] of the "
                               "kernel's da", a, b_ref, PRODUCT_RTOL)
                   for i, (a, b_ref) in enumerate(zip(
                       dw32, fl.reference_tc_dw(grad32), strict=True)))
    again = (fl.tc_dh(grad32), *fl.tc_dw(grad32))
    if not all(torch.equal(a, b_) for a, b_ in zip((dh32, *dw32), again)):
        raise AssertionError("cp_backward float32 products differ between "
                             "two runs")

    # Bounds: the larger of each function's bytes and its product, 2·M·H·F
    # counted once however many pairs of terms the design multiplies, at
    # the bf16 tensor-core rate.  The bytes are what each function needs:
    # with bf16 h, da as its CP_TERMS bf16 terms once (not the scratch's
    # copy of da_0 per pair), h once (not once per pair), W and dW in
    # float32; with float32 h, h in float32 and the function's da once at
    # 4 B an element (not its bf16 terms, nor the scratch's copies per
    # pair).
    product = 2 * m * hidden * f
    head_bytes = (hidden * f + f) * 4
    t_bytes = m * f * x.element_size()
    in_bytes = m * hidden * 2 + head_bytes + t_bytes + m * 4
    da_terms = m * f * 2 * fl.CP_TERMS
    db_bytes = grad.db_parts.numel() * 4
    timed = dict(flush=flush)
    w2 = grad.w.reshape(grad.w.shape[0], -1)
    results = {}
    for kernel, fn, plain_fn, library, err, nbytes in (
        ("cp_forward", lambda: ops.cp_forward(*full),
         lambda: fl.reference_cp_tc_forward(*full), None, fwd_err,
         in_bytes + 2 * m * 4),
        ("cp_backward_gradient",
         lambda: fl.cp_tc_gradient(g, hb, w, b, x, lse_main),
         lambda: fl.reference_cp_tc_gradient(g, hb, w, b, x, lse_main), None,
         grad_err, in_bytes + 2 * m * 4 + da_terms + db_bytes),
        ("cp_backward_dh", lambda: fl.tc_dh(grad),
         lambda: fl.reference_tc_dh(grad),
         lambda: torch.mm(grad.da, w2.T, out_dtype=torch.float32), dh_err,
         da_terms + hidden * f * 4 + m * hidden * 4),
        ("cp_backward_dw", lambda: fl.tc_dw(grad),
         lambda: fl.reference_tc_dw(grad), dw_yardstick(grad), dw_err,
         m * hidden * 2 + da_terms + db_bytes + head_bytes),
    ):
        t_bound, by = bound(nbytes, product, BF16_FLOPS)
        library_ms = None
        if library is not None:
            try:  # torch.mm with a float32 output from bf16 operands
                library_ms = time_ms(library, **timed)
            except (RuntimeError, TypeError) as err_:
                log(f"library call for {kernel} unavailable: {err_}")
        results[kernel] = {
            "max_abs_err": err, "ms": time_ms(fn, **timed),
            "plain_ms": time_ms(plain_fn, **timed), "bound_ms": t_bound,
            "bound_by": by, "library_ms": library_ms,
        }
    # the public calls against the float32 plain versions of the function
    plain32 = {
        "forward": (lambda: ops.cp_forward(*full),
                    lambda: ops.reference_cp_forward(hv, *full[1:])),
        "backward": (lambda: ops.cp_backward(g, hb, w, b, x, lse_main),
                     lambda: (ops.reference_cp_dh(g, hv, w, b, x, lse_main),
                              *ops.reference_cp_dw(g, hv, w, b, x,
                                                   lse_main))),
    }
    print("cp bf16 public calls against the float32 plain versions: "
          + "; ".join(f"{label} {time_ms(fn, **timed):.4f} ms (float32 plain "
                      f"{time_ms(plain_fn, **timed):.4f} ms)"
                      for label, (fn, plain_fn) in plain32.items()),
          flush=True)

    f32_in = m * hidden * 4 + head_bytes + t_bytes + m * 4
    db32_bytes = grad32.db_parts.numel() * 4
    da32_bytes = m * f * 4
    # the float32 da of the plain version, for the library's dh product
    da32 = fl._cp_da(g, h, w, b, x, lse_f32)[1]
    for kernel, fn, plain_fn, library, err, nbytes in (
        ("forward", lambda: ops.cp_forward(*f32_full),
         lambda: fl.reference_cp_f32_tc_forward(*f32_full), None,
         f32_fwd_err, f32_in + 2 * m * 4),
        ("backward_gradient", lambda: fl.cp_f32_tc_gradient(*bwd32),
         lambda: fl.reference_cp_f32_tc_gradient(*bwd32), None, grad32_err,
         f32_in + 2 * m * 4 + da32_bytes + db32_bytes),
        ("backward_dh", lambda: fl.tc_dh(grad32),
         lambda: fl.reference_tc_dh(grad32), lambda: torch.mm(da32, w.T),
         dh32_err, da32_bytes + hidden * f * 4 + m * hidden * 4),
        ("backward_dw", lambda: fl.tc_dw(grad32),
         lambda: fl.reference_tc_dw(grad32), dw_yardstick(grad32, h, da32),
         dw32_err,
         m * hidden * 4 + da32_bytes + db32_bytes + head_bytes),
    ):
        t_bound, by = bound(nbytes, product, BF16_FLOPS)
        results[f"cp_{kernel}_float32"] = {
            "max_abs_err": err, "ms": time_ms(fn, **timed),
            "plain_ms": time_ms(plain_fn, **timed), "bound_ms": t_bound,
            "bound_by": by,
            "library_ms": None if library is None else time_ms(library,
                                                               **timed),
        }
    parts32 = sum(results[f"cp_{kernel}_float32"]["ms"] for kernel in
                  ("backward_gradient", "backward_dh", "backward_dw"))
    public = {
        "cp_forward": (lambda: ops.cp_forward(*f32_full),
                       lambda: ops.reference_cp_forward(*f32_full)),
        "cp_backward": (lambda: ops.cp_backward(*bwd32),
                        lambda: (ops.reference_cp_dh(*bwd32),
                                 *ops.reference_cp_dw(*bwd32))),
    }
    print(f"float32 cp M={m}: backward kernels {parts32:.4f} ms; public "
          "calls against the float32 plain versions: " + "; ".join(
              f"{label} {time_ms(fn, **timed):.4f} ms (float32 plain "
              f"{time_ms(plain_fn, **timed):.4f} ms)"
              for label, (fn, plain_fn) in public.items())
          + "; the split of h and W in torch ops (the plain version of the "
          "entries' split_pack_kernel) "
          f"{time_ms(lambda: fl._f32_tc_operands(h, [w]), **timed):.4f} ms",
          flush=True)
    return results


def categorised_targets(x, k_max, gen):
    """The minibatch's counts with every other row drawn anew as Poisson(K),
    so that about a quarter of the elements reach K and the base heads'
    branch (t ≥ K) is checked with gradients that are not all zero."""
    t = x.clone()
    rate = torch.full(t[1::2].shape, float(k_max), device=t.device)
    t[1::2] = torch.poisson(rate, generator=gen).to(t.dtype)
    over = int((t >= k_max).sum())
    if over < t.numel() // 100:
        raise AssertionError(f"only {over} targets reach K = {k_max}")
    return t


def check_categorised(name, k_max, h, g, x, gen, flush):
    """The categorised K2 and K3 over base ``name`` with K = ``k_max``, on
    the targets of ``categorised_targets``: the forward (row sums and the
    per-element lse, and the row-sum partials per gene tile against the
    plain version in the kernel's layout; bf16 inputs on the main path's
    tensor-core kernel, the same lse over two runs; float32 inputs, h and
    every W as three bf16 terms on the same kernel, also against the
    float32 plain version; ragged F, float32 targets); the bf16 backward
    (the tensor-core gradient kernel, then the dh and dW products) against
    the plain backward with the same rounding (and ragged F); the float32
    backward (the same kernels on bf16 terms of h, W and da) against
    autograd through the float32 plain forward; each of the backward's
    three kernels, bf16 and float32, against its plain version (float32:
    the split of h and W bit for bit, ``check_split_da``); then their
    times.  Every gradient part of the plain backward must be nonzero
    somewhere."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import fused_likelihood as fl

    bf16 = torch.bfloat16
    x = categorised_targets(x, k_max, gen)
    fam = ops.FAMILIES[name]
    n_base = len(fam.heads)
    m, hidden = h.shape
    f = x.shape[1]
    ws, bs = head_weights(gen, n_base + k_max + 1, hidden, f, h.device)
    cw, cb = torch.stack(ws[n_base:]), torch.stack(bs[n_base:])
    ws, bs = ws[:n_base], bs[:n_base]
    full = (ws, bs, cw, cb, x)
    ragged = (_cut(ws, 2000), _cut(bs, 2000), cw[..., :2000].contiguous(),
              cb[..., :2000].contiguous(), x[:, :2000].contiguous())
    tag = f"cat_{fam.prefix}"
    heads = f"{n_base + k_max + 1} heads"
    # The forward, bf16 and float32, on the tensor-core kernel: against the
    # plain version with the same rounding (float32: the float32 plain
    # version), and its row-sum partials per gene tile against the plain
    # version in the kernel's layout (float32: of the split design, whose
    # row sums and lse it is also held against).
    for args, cdt in ((full, bf16), (ragged, bf16), (full, None),
                      (ragged, None), ((ws, bs, cw, cb, x.float()), bf16)):
        ll, lse = ops.categorised_forward(name, h, *args, compute_dtype=cdt)
        ll_ref, lse_ref = ops.reference_categorised_forward(
            name, h, *args, compute_dtype=cdt)
        label = (f"{tag}_forward {heads} F={args[-1].shape[1]} {cdt} "
                 f"t={args[-1].dtype}")
        err = check_close(label, ll, ll_ref, FORWARD_RTOL)
        check_close(label + " lse", lse, lse_ref, FORWARD_RTOL)
        if cdt is bf16:
            part = fl.cat_tc_forward(name, h, *args)[2]
            check_close(label + " row-sum partials", part,
                        fl.reference_cat_tc_forward(name, h, *args)[0],
                        FORWARD_RTOL)
        else:
            split = fl.reference_cat_f32_tc_forward(name, h, *args)
            for part_name, a, b in zip(
                    ("row sums", "lse", "row-sum partials"),
                    fl.cat_f32_tc_forward(name, h, *args), split,
                    strict=True):
                err_ = check_close(f"{label} {part_name} vs split plain", a,
                                   b, FORWARD_RTOL)
                if args is full and part_name == "row sums":
                    f32_fwd_err = err_
        if args is full:
            if cdt is bf16:
                fwd_err, lse_main = err, lse
            else:
                lse32 = lse
    for cdt, want in ((bf16, lse_main), (None, lse32)):
        again = ops.categorised_forward(name, h, *full, compute_dtype=cdt)[1]
        if not torch.equal(again, want):
            raise AssertionError(f"{tag}_forward {heads} {cdt}: lse differs "
                                 "between two runs")
    parts = (["dh"] + [f"{p}_{head}" for head in fam.heads for p in ("dW", "db")]
             + ["dW_classes", "db_classes"])
    # The bf16 backward on the same inputs, the forward's lse among them: an
    # lse that differs in its last bit moves some da_c across a bf16
    # rounding boundary (one such flip read 5.5e-4 of the largest
    # dW_classes).
    for args in (full, ragged):
        _, lse = ops.categorised_forward(name, h, *args, compute_dtype=bf16)
        got = ops.categorised_backward(name, g, h, *args, lse,
                                       compute_dtype=bf16)
        want = (ops.reference_categorised_dh(name, g, h, *args, lse,
                                             compute_dtype=bf16),
                *ops.reference_categorised_dw(name, g, h, *args, lse,
                                              compute_dtype=bf16))
        for part, b in zip(parts, want):
            if not float(b.abs().max()) > 0:
                raise AssertionError(f"{tag} {heads}: plain {part} is all 0")
        for part, a, b in zip(parts, got, want, strict=True):
            check_close(f"{tag}_backward {heads} {part} "
                        f"F={args[-1].shape[1]}", a, b, BACKWARD_RTOL)
    # the float32 backward (the tensor-core kernels on bf16 terms) against
    # autograd through the float32 plain forward
    leaves = [a.clone().requires_grad_(True) for a in (h, *ws, *bs, cw, cb)]
    ll, _ = ops.reference_categorised_forward(
        name, leaves[0], leaves[1:1 + n_base], leaves[1 + n_base:1 + 2 * n_base],
        leaves[-2], leaves[-1], x)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)
    _, lse = ops.categorised_forward(name, h, *full)
    got = ops.categorised_backward(name, g, h, *full, lse)
    order = ([0] + [i for j in range(n_base) for i in (1 + j, 1 + n_base + j)]
             + [1 + 2 * n_base, 2 + 2 * n_base])
    for part, a, i in zip(parts, got, order):
        check_close(f"{tag}_backward float32 {heads} {part} vs autograd", a,
                    want[i], AUTOGRAD_RTOL)

    # The bf16 backward kernel by kernel on the main path's inputs: the
    # gradient kernel's bf16(da) within one bf16 step of the plain bf16(da)
    # from the same lse, its row-tile sums, and the dh and dW products of
    # its own da against the plain products.
    bwd = (name, g, h, *full, lse_main)
    plain = fl.reference_cat_tc_gradient(*bwd)
    grad = fl.cat_tc_gradient(*bwd)
    grad_err = check_bf16_steps(f"{tag}_backward_gradient {heads} bf16(da)",
                                grad.da, plain.da)
    check_close(f"{tag}_backward_gradient {heads} db row-tile sums",
                grad.db_parts, plain.db_parts, PRODUCT_RTOL)
    dh_err = check_close(f"{tag}_backward_dh {heads} of the kernel's da",
                         fl.tc_dh(grad), fl.reference_tc_dh(grad),
                         PRODUCT_RTOL)
    dw_err = max(check_close(f"{tag}_backward_dw {heads} [{i}] of the "
                             "kernel's da", a, b, PRODUCT_RTOL)
                 for i, (a, b) in enumerate(zip(
                     fl.tc_dw_stacked(grad), fl.reference_tc_dw_stacked(grad),
                     strict=True)))
    # The float32 backward kernel by kernel on the main path's inputs: the
    # split of h and W, da's terms and row-tile sums against the plain
    # version of the split design from the same lse, and the dh and dW
    # products of the kernel's own scratch against the plain products.
    bwd32 = (name, g, h, *full, lse32)
    grad32 = fl.cat_f32_tc_gradient(*bwd32)
    plain32 = fl.reference_cat_f32_tc_gradient(*bwd32)
    grad32_err = check_split_da(tag, grad32, plain32)
    check_close(f"{tag}_backward_gradient_float32 {heads} db row-tile sums",
                grad32.db_parts, plain32.db_parts, PRODUCT_RTOL)
    del plain32
    dh32_err = check_close(f"{tag}_backward_dh_float32 {heads} of the "
                           "kernel's da", fl.tc_dh(grad32),
                           fl.reference_tc_dh(grad32), PRODUCT_RTOL)
    dw32_err = max(check_close(f"{tag}_backward_dw_float32 {heads} [{i}] of "
                               "the kernel's da", a, b, PRODUCT_RTOL)
                   for i, (a, b) in enumerate(zip(
                       fl.tc_dw_stacked(grad32),
                       fl.reference_tc_dw_stacked(grad32), strict=True)))

    # Why the planner promotes deep sums: the dh product in 3 splits, its
    # sums inside the tensor cores and promoted, against the plain product
    deep, promoted = (forced_splits(grad, 3, promote) for promote in
                      (False, True))
    want = fl.reference_tc_dh(grad)
    scale = float(want.abs().max())
    print(f"precision {tag} {heads} dh product over 3 splits of "
          f"{deep.plan['dh_splits'][1] * fl.TC_PRODUCT_DEPTH} deep: "
          f"unpromoted {max_err(fl.tc_dh(deep), want) / scale:.3g}, "
          f"promoted {max_err(fl.tc_dh(promoted), want) / scale:.3g} of the "
          f"largest value; as planned {grad.plan['dh_splits']} "
          f"{dh_err / scale:.3g}", flush=True)

    # Bounds: the function's product 2·NH·M·H·F, counted once however many
    # pairs of terms the float32 design multiplies, at the bf16 tensor-core
    # rate, or its bytes: h and the heads in float32 as the caller holds
    # them, t in bf16, lse in float32; da as the kernels pass it in bf16,
    # the float32 function's da once at 4 B an element (not its bf16 terms,
    # nor the scratch's copies per pair).
    n_heads = n_base + k_max + 1
    product = 2 * n_heads * m * hidden * f
    head_bytes = n_heads * (hidden * f + f) * 4
    in_bytes = m * hidden * 4 + head_bytes + m * f * 2
    lse_bytes = m * f * 4
    db_bytes = grad.db_parts.numel() * 4
    timed = dict(flush=flush)
    results = {}
    for sfx, cdt, grd, gradient, plain_gradient, plain_forward, errs in (
        ("", bf16, grad, fl.cat_tc_gradient, fl.reference_cat_tc_gradient,
         lambda: ops.reference_categorised_forward(name, h, *full,
                                                   compute_dtype=bf16),
         (fwd_err, grad_err, dh_err, dw_err)),
        ("_float32", None, grad32, fl.cat_f32_tc_gradient,
         fl.reference_cat_f32_tc_gradient,
         lambda: fl.reference_cat_f32_tc_forward(name, h, *full),
         (f32_fwd_err, grad32_err, dh32_err, dw32_err)),
    ):
        bwd_args = bwd if cdt is bf16 else bwd32
        if cdt is bf16:
            da_bytes, h_bytes, w_bytes = (grd.da.numel() * 2,
                                          grd.h.numel() * 2,
                                          grd.w.numel() * 2)
        else:
            da_bytes, h_bytes, w_bytes = (m * n_heads * f * 4,
                                          m * hidden * 4,
                                          n_heads * hidden * f * 4)
        w2 = grd.w.reshape(grd.w.shape[0], -1)
        kernels = {  # fn, plain, library, err, bytes
            "forward": (
                lambda cdt=cdt: ops.categorised_forward(
                    name, h, *full, compute_dtype=cdt),
                plain_forward, None, errs[0], in_bytes + m * 4 + lse_bytes),
            "backward_gradient": (
                lambda gradient=gradient, a=bwd_args: gradient(*a),
                lambda plain=plain_gradient, a=bwd_args: plain(*a), None,
                errs[1], in_bytes + m * 4 + lse_bytes + da_bytes + db_bytes),
            "backward_dh": (
                lambda grd=grd: fl.tc_dh(grd),
                lambda grd=grd: fl.reference_tc_dh(grd),
                lambda grd=grd, w2=w2: torch.mm(grd.da, w2.T,
                                                out_dtype=torch.float32),
                errs[2], da_bytes + w_bytes + m * hidden * 4),
            "backward_dw": (
                lambda grd=grd: fl.tc_dw_stacked(grd),
                lambda grd=grd: fl.reference_tc_dw_stacked(grd),
                dw_yardstick(grd, None if cdt is bf16 else h),
                errs[3], h_bytes + da_bytes + db_bytes + head_bytes),
        }
        for kernel, (fn, plain_fn, library, err, nbytes) in kernels.items():
            t_bound, by = bound(nbytes, product, BF16_FLOPS)
            results[f"{tag}_{kernel}{sfx}"] = {
                "max_abs_err": err, "ms": time_ms(fn, **timed),
                "plain_ms": time_ms(plain_fn, **timed),
                "bound_ms": t_bound, "bound_by": by,
                "library_ms": None if library is None else time_ms(library,
                                                                   **timed),
            }
    parts_ms = sum(results[f"{tag}_{kernel}"]["ms"] for kernel in
                   ("backward_gradient", "backward_dh", "backward_dw"))
    whole_bound, whole_by = bound(
        in_bytes + m * 4 + lse_bytes + m * hidden * 4 + head_bytes,
        3 * product, BF16_FLOPS)
    whole = time_ms(lambda: ops.categorised_backward(*bwd, compute_dtype=bf16),
                    **timed)
    print(f"backward {tag} {heads}: gradient + dh + dW kernels "
          f"{parts_ms:.4f} ms; categorised_backward with its operand copies "
          f"{whole:.4f} ms; bound {whole_bound:.5f} ms ({whole_by})",
          flush=True)
    parts32 = sum(results[f"{tag}_{kernel}_float32"]["ms"] for kernel in
                  ("backward_gradient", "backward_dh", "backward_dw"))
    public = {
        "categorised_forward": (
            lambda: ops.categorised_forward(name, h, *full),
            lambda: ops.reference_categorised_forward(name, h, *full)),
        "categorised_backward": (
            lambda: ops.categorised_backward(*bwd32),
            lambda: (ops.reference_categorised_dh(*bwd32),
                     *ops.reference_categorised_dw(*bwd32))),
    }
    print(f"float32 {tag} {heads}: backward kernels {parts32:.4f} ms; public "
          "calls against the float32 plain versions: " + "; ".join(
              f"{label} {time_ms(fn, **timed):.4f} ms (float32 plain "
              f"{time_ms(plain_fn, **timed):.4f} ms)"
              for label, (fn, plain_fn) in public.items())
          + "; the split of h and every W in torch ops (the plain version "
          "of the entries' split_pack_kernel) "
          f"{time_ms(lambda: fl._f32_tc_operands(h, ws, cw), **timed):.4f} "
          "ms", flush=True)
    return results


def check_cycled_rows(x, gen, flush):
    """NB's K2 and both K3 passes as the GMVAE-NB step runs them: one launch
    over its K·S·B = 20,480 decoder rows against the 2,048 target rows of
    the minibatch, which cycle; bf16 inputs, the staged lgamma constant."""
    from scvae_tpu_torch import ops

    bf16 = torch.bfloat16
    name = "negative binomial"
    m_t, f = x.shape
    m = CLUSTERS * m_t
    h = torch.relu(torch.randn(m, HIDDEN, generator=gen, device=x.device))
    g = torch.randn(m, generator=gen, device=x.device) / m_t
    ws, bs = head_weights(gen, 2, HIDDEN, f, x.device)
    kw = dict(compute_dtype=bf16)
    fwd_err = check_close(
        f"nb_forward M={m} over {m_t} target rows",
        ops.fused_forward(name, h, ws, bs, x, include_lgamma_const=False, **kw),
        ops.reference_forward(name, h, ws, bs, x, include_lgamma_const=False,
                              **kw), FORWARD_RTOL)
    got = ops.fused_backward(name, g, h, ws, bs, x, **kw)
    want = ops.reference_backward(name, g, h, ws, bs, x, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        check_close(f"nb_backward [{i}] M={m} over {m_t} target rows", a, b,
                    BACKWARD_RTOL)
    results = count_kernel_times(name, h, g, ws, bs, x, flush, fwd_err,
                                 tag="nb", reps=10)
    return {f"{kernel}_cycled": values for kernel, values in results.items()}


# Phase 3's gene-block launches (the model axis's kernels on one card): the
# split autograd Functions of ``ops.sharded`` with no group, once per block
# of GENE_BLOCKS, at the headline shapes: (label, likelihood, classes,
# decoder rows as a multiple of the minibatch's).
GENE_BLOCKS = 2
GENE_BLOCK_CASES = (("nb", "negative binomial", 0, 1),
                    ("nb_cycled", "negative binomial", 0, CLUSTERS),
                    ("cat_zinb", "zero-inflated negative binomial", 10, 1))


def check_gene_blocks(x, gen, flush, card):
    """Each GENE_BLOCK_CASES case on the gene split's path with the model
    group of a card of its own: bf16 inputs, the decoder rows against the
    minibatch's targets (cycled for the GMVAE's), the heads of F = 2,048
    genes cut in two blocks of 1,024; each block through
    ``ops.sharded_fused_log_likelihood`` (the categorised:
    ``sharded_fused_categorised_log_likelihood``) with a ``GeneSplit`` of
    no group, forward and backward (autograd, the row cotangents g).  The
    row sums and dh summed over the blocks, the heads' gradients put
    together, are held against the whole-F kernels and against the plain
    versions within phase 3's bounds for those kernels.  Prints the
    blocks' kernel times beside the whole-F kernels' (the same
    ``fused_forward`` / ``fused_backward`` or categorised calls that the
    split Functions make, on the blocks cut beforehand)."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.parallel import GeneSplit

    bf16 = torch.bfloat16
    m_t, f = x.shape
    splits = [GeneSplit(i, GENE_BLOCKS) for i in range(GENE_BLOCKS)]
    for label, name, k_max, groups in GENE_BLOCK_CASES:
        m = groups * m_t
        heads_of = ops.FAMILIES[name].heads
        n_base = len(heads_of)
        h = torch.relu(torch.randn(m, HIDDEN, generator=gen, device=x.device))
        g = torch.randn(m, generator=gen, device=x.device) / m_t
        t = categorised_targets(x, k_max, gen) if k_max else x
        ws, bs = head_weights(gen, n_base + (k_max + 1 if k_max else 0),
                              HIDDEN, f, x.device)
        classes = ([torch.stack(ws[n_base:]), torch.stack(bs[n_base:])]
                   if k_max else [])
        ws, bs = ws[:n_base], bs[:n_base]
        kw = dict(compute_dtype=bf16)
        if k_max:
            ll, lse = ops.categorised_forward(name, h, ws, bs, *classes, t,
                                              **kw)
            plain, plain_lse = ops.reference_categorised_forward(
                name, h, ws, bs, *classes, t, **kw)
            args = (name, g, h, ws, bs, *classes, t)
            whole = [ll, *ops.categorised_backward(*args, lse, **kw)]
            plain = [plain,
                     ops.reference_categorised_dh(*args, plain_lse, **kw),
                     *ops.reference_categorised_dw(*args, plain_lse, **kw)]
        else:
            fwd = dict(kw, include_lgamma_const=False)
            whole = [ops.fused_forward(name, h, ws, bs, t, **fwd),
                     *ops.fused_backward(name, g, h, ws, bs, t, **kw)]
            plain = [ops.reference_forward(name, h, ws, bs, t, **fwd),
                     *ops.reference_backward(name, g, h, ws, bs, t, **kw)]
        # the blocks: row sums and dh summed, the heads' gradients put
        # together in the layout of the whole-F calls
        sums = [0.0, 0.0]
        parts = [[] for _ in range(2 * n_base + len(classes))]
        for split in splits:
            hv = h.clone().requires_grad_(True)
            leaves = [split.block(a).contiguous().requires_grad_(True)
                      for w, b in zip(ws, bs) for a in (w, b)]
            cut = [split.block(c).contiguous().requires_grad_(True)
                   for c in classes]
            heads = {p: {"kernel": leaves[2 * i], "bias": leaves[2 * i + 1]}
                     for i, p in enumerate(heads_of)}
            if k_max:
                out = ops.sharded_fused_categorised_log_likelihood(
                    name, hv, heads, *cut, t, genes=split, **kw)
            else:
                out = ops.sharded_fused_log_likelihood(
                    name, hv, heads, t, genes=split,
                    include_lgamma_const=False, **kw)
            dh, *grads = torch.autograd.grad(out, [hv, *leaves, *cut],
                                             grad_outputs=g)
            sums = [sums[0] + out.detach(), sums[1] + dh]
            for part, grad in zip(parts, grads):
                part.append(grad)
        got = [*sums, *(torch.cat(part, -1) for part in parts)]
        names = (["row sums", "dh"]
                 + [f"{p}_{head}" for head in heads_of for p in ("dW", "db")]
                 + (["dW_classes", "db_classes"] if k_max else []))
        for what, against in (("the whole-F kernels", whole),
                              ("the plain versions", plain)):
            for i, (part, a, b) in enumerate(zip(names, got, against,
                                                 strict=True)):
                check_close(f"gene blocks {label} M={m} {part} vs {what}", a,
                            b, FORWARD_RTOL if i == 0 else BACKWARD_RTOL)
        # times: each block's calls against the whole-F calls
        cut_t = [split.block(t).contiguous() for split in splits]
        cut_w = [[split.block(w).contiguous() for w in ws] for split in splits]
        cut_b = [[split.block(b).contiguous() for b in bs] for split in splits]
        cut_c = [[split.block(c).contiguous() for c in classes]
                 for split in splits]
        if k_max:
            lses = [ops.categorised_forward(name, h, cut_w[i], cut_b[i],
                                            *cut_c[i], cut_t[i], **kw)[1]
                    for i in range(GENE_BLOCKS)]
            calls = {
                "forward": (
                    lambda i: ops.categorised_forward(
                        name, h, cut_w[i], cut_b[i], *cut_c[i], cut_t[i],
                        **kw),
                    lambda: ops.categorised_forward(name, h, ws, bs,
                                                    *classes, t, **kw)),
                "backward": (
                    lambda i: ops.categorised_backward(
                        name, g, h, cut_w[i], cut_b[i], *cut_c[i], cut_t[i],
                        lses[i], **kw),
                    lambda: ops.categorised_backward(
                        name, g, h, ws, bs, *classes, t, lse, **kw)),
            }
        else:
            calls = {
                "forward": (
                    lambda i: ops.fused_forward(name, h, cut_w[i], cut_b[i],
                                                cut_t[i], **fwd),
                    lambda: ops.fused_forward(name, h, ws, bs, t, **fwd)),
                "backward": (
                    lambda i: ops.fused_backward(name, g, h, cut_w[i],
                                                 cut_b[i], cut_t[i], **kw),
                    lambda: ops.fused_backward(name, g, h, ws, bs, t, **kw)),
            }
        timed = []
        for kind, (block, whole_call) in calls.items():
            blocks = [time_ms(lambda i=i: block(i), reps=10, flush=flush)
                      for i in range(GENE_BLOCKS)]
            timed.append(
                f"{kind} " + " + ".join(f"{ms:.4f}" for ms in blocks)
                + f" ms on {GENE_BLOCKS} blocks of {f // GENE_BLOCKS} genes, "
                f"{time_ms(whole_call, reps=10, flush=flush):.4f} ms on "
                f"{f} genes")
        print(f"gene blocks {label} M={m} over {m_t} target rows: "
              + "; ".join(timed) + f" ({card})", flush=True)


def check_over_budget_genes(g, gen, flush):
    """NB's K2 and K3's three kernels as the over-budget run (phase 4e)
    calls them: a 2,048-row minibatch of 4,096 genes, Poisson(3) + 1 at
    density 0.07, bf16 inputs, decoder width 256; against their plain
    versions, then kernel by kernel and timed (entries "nb_4096_…")."""
    from scvae_tpu_torch import ops

    bf16 = torch.bfloat16
    name = "negative binomial"
    m, dev = g.shape[0], g.device
    counts = torch.poisson(torch.full((m, OVER_GENES), 3.0, device=dev),
                           generator=gen) + 1.0
    kept = torch.rand(m, OVER_GENES, generator=gen, device=dev) < 0.07
    x = torch.where(kept, counts, 0.0).to(bf16)
    h = torch.relu(torch.randn(m, HIDDEN, generator=gen, device=dev))
    ws, bs = head_weights(gen, 2, HIDDEN, OVER_GENES, dev)
    kw = dict(compute_dtype=bf16)
    fwd_err = check_close(
        f"nb_forward F={OVER_GENES}",
        ops.fused_forward(name, h, ws, bs, x, include_lgamma_const=False, **kw),
        ops.reference_forward(name, h, ws, bs, x, include_lgamma_const=False,
                              **kw), FORWARD_RTOL)
    got = ops.fused_backward(name, g, h, ws, bs, x, **kw)
    want = ops.reference_backward(name, g, h, ws, bs, x, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        check_close(f"nb_backward [{i}] F={OVER_GENES}", a, b, BACKWARD_RTOL)
    return count_kernel_times(name, h, g, ws, bs, x, flush, fwd_err,
                              tag="nb_4096", reps=10)


@contextlib.contextmanager
def replaced(module, name, value):
    """``module.name`` set to ``value`` for the block (a measurement's
    variant of a plan or a launch setting)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def check_grouped(name, x, gen, flush, n_groups):
    """K4 and K5 of base family ``name`` at the GMVAE's shapes: h (G, M, H)
    against the minibatch's targets (M, F), row weights as uneven as q(y|x)
    (a softmax over the groups), bf16 and float32 (check_grouped_dtype).
    Returns, at G = 10, each kernel's times."""
    from scvae_tpu_torch import ops

    m, f = x.shape
    dev = x.device
    h = torch.relu(torch.randn(n_groups, m, HIDDEN, generator=gen, device=dev))
    g = torch.softmax(2 * torch.randn(n_groups, m, generator=gen, device=dev),
                      dim=0) / m
    ws, bs = head_weights(gen, len(ops.FAMILIES[name].heads), HIDDEN, f, dev)
    results = {}
    for float32 in (False, True):
        results.update(check_grouped_dtype(name, h, g, ws, bs, x, flush,
                                           float32))
    return results


def check_grouped_dtype(name, h, g, ws, bs, x, flush, float32):
    """The grouped K4 and K5 of family ``name`` with bf16 operands, or with
    ``float32`` h, W and da as ``fl.SPLIT_TERMS`` bf16 terms (counters with
    the "_float32" suffix).  K4 against its plain version (float32: the
    split design's and the float32 plain version), bit for bit over two
    runs; K5 kernel by kernel (the grouped gradient kernel's bf16(da) within
    one bf16 step of the plain bf16(da), float32 as check_split_da holds the
    flat float32 scratch; its column sums per 64 target rows over every
    group; the dh and dW products of its own da against the plain products,
    bit for bit over two runs) and as a whole against the per-group plain
    versions (float32: and autograd through the float32 plain forward);
    NB's against the flat kernels over the G·M group-major rows with cycled
    targets (the lgamma constant included, as K4 always subtracts it).
    Then, at G = 10, their times, beside the flat tensor-core kernels over
    the same rows, and the float32 gradient kernel's with fewer W slots."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import fused_likelihood as fl

    fam = ops.FAMILIES[name]
    k = len(fam.heads)
    n_groups, m, _ = h.shape
    f = x.shape[1]
    rows = n_groups * m
    cdt, sfx = (None, "_float32") if float32 else (torch.bfloat16, "")
    kw = dict(compute_dtype=cdt)
    args = (name, h, ws, bs, x)
    bargs = (name, g, h, ws, bs, x)
    tag = f"{fam.prefix}_grouped G={n_groups}"
    out = ops.grouped_forward(*args, **kw)
    if float32:
        gradient = fl.grouped_f32_tc_gradient
        plain_gradient = fl.reference_grouped_f32_tc_gradient

        def plain_forward():
            return fl.reference_grouped_f32_tc_forward(*args)
        check_close(f"{tag} forward_float32 vs float32 plain", out,
                    ops.reference_grouped_forward(*args), FORWARD_RTOL)
    else:
        gradient, plain_gradient = (fl.grouped_tc_gradient,
                                    fl.reference_grouped_tc_gradient)

        def plain_forward():
            return ops.reference_grouped_forward(*args, **kw)
    fwd_err = check_close(f"{tag} forward{sfx}", out, plain_forward(),
                          FORWARD_RTOL)
    if not torch.equal(out, ops.grouped_forward(*args, **kw)):
        raise AssertionError(f"{tag} forward{sfx} differs between two runs")
    grad = gradient(*bargs)
    plain = plain_gradient(*bargs)
    if float32:
        grad_err = check_split_da(tag, grad, plain)
    else:
        grad_err = check_bf16_steps(f"{tag} backward_gradient bf16(da)",
                                    grad.da, plain.da)
    check_close(f"{tag} backward_gradient{sfx} db sums per 64 target rows",
                grad.db_parts, plain.db_parts, PRODUCT_RTOL)
    dh = fl.tc_dh(grad)
    dh_err = check_close(f"{tag} backward_dh{sfx} of the kernel's da", dh,
                         fl.reference_tc_dh(grad), PRODUCT_RTOL)
    dws = fl.tc_dw(grad)
    dw_err = max(check_close(f"{tag} backward_dw{sfx} [{i}] of the kernel's "
                             "da", a, b, PRODUCT_RTOL)
                 for i, (a, b) in enumerate(zip(
                     dws, fl.reference_tc_dw(grad), strict=True)))
    again = (fl.tc_dh(grad), *fl.tc_dw(grad))
    if not all(torch.equal(a, b) for a, b in zip((dh, *dws), again)):
        raise AssertionError(f"{tag}{sfx}: the products differ between two "
                             "runs")
    parts = ["dh"] + [f"{p}_{head}" for head in fam.heads for p in ("dW", "db")]
    got = ops.grouped_backward(*bargs, **kw)
    if not all(torch.equal(a, b) for a, b in zip(
            got, (dh.reshape(h.shape), *dws), strict=True)):
        raise AssertionError(f"{tag}{sfx}: the public backward is not the "
                             "three kernels")
    rtol = AUTOGRAD_RTOL if float32 else BACKWARD_RTOL
    for part, a, b in zip(parts, got, (
            ops.reference_grouped_dh(*bargs, **kw),
            *ops.reference_grouped_dw(*bargs, **kw)), strict=True):
        check_close(f"{tag} backward{sfx} {part}", a, b, rtol)
    if float32:
        leaves = [a.clone().requires_grad_(True) for a in (h, *ws, *bs)]
        ll = ops.reference_grouped_forward(name, leaves[0], leaves[1:1 + k],
                                           leaves[1 + k:], x)
        want = torch.autograd.grad(ll, leaves, grad_outputs=g)
        order = [0] + [i for j in range(k) for i in (1 + j, 1 + k + j)]
        for part, a, i in zip(parts, got, order):
            check_close(f"{tag} backward float32 {part} vs autograd", a,
                        want[i], AUTOGRAD_RTOL)
        del leaves, ll, want
    h2, g2 = h.reshape(rows, -1), g.reshape(rows)
    flat_args = (name, g2, h2, ws, bs, x)
    if name == "negative binomial":
        flat = f"flat over {rows} cycled rows"
        check_close(f"{tag} forward{sfx} vs {flat}", out.reshape(-1),
                    ops.fused_forward(name, h2, ws, bs, x, **kw), FORWARD_RTOL)
        for part, a, b in zip(parts, got, ops.fused_backward(*flat_args,
                                                             **kw)):
            check_close(f"{tag} {part}{sfx} vs {flat}", a.reshape(b.shape), b,
                        rtol)
    del got, again, plain
    if n_groups != CLUSTERS:
        return {}

    # Bounds: the function's bytes, each input read once and each output
    # written once (h and the heads in float32 as the caller holds them, t
    # as (M, F) once for every group; bf16: bf16(da) once, the products'
    # bf16 h; float32: the function's float32 da once at 4 B an element, not
    # its bf16 terms, and the float32 h and W), against the heads' products,
    # 2·NH·G·M·H·F, counted once however many pairs of terms, at the bf16
    # tensor-core rate.
    product = 2 * k * rows * HIDDEN * f
    head_bytes = k * (HIDDEN * f + f) * 4
    in_bytes = rows * HIDDEN * 4 + head_bytes + m * f * x.element_size()
    timed = dict(flush=flush, reps=10)
    fp = fl.tc_padded(f)
    if float32:
        da_bytes, db_bytes = rows * k * f * 4, grad.db_parts.numel() * 4
        gradient_bytes = in_bytes + rows * 4 + da_bytes + db_bytes
        dw_bytes = rows * HIDDEN * 4 + da_bytes + db_bytes + head_bytes
        # the float32 da (G·M, NH·Fp), the sum of its terms, and Wᵀ
        first = [fl.SPLIT_PAIRS.index((i, 0)) for i in range(fl.SPLIT_TERMS)]
        terms = grad.da.reshape(rows, len(fl.SPLIT_PAIRS), -1)
        da32 = sum(terms[:, p].float() for p in first)
        w32 = torch.zeros((k, fp, HIDDEN), device=x.device)
        w32[:, :f] = torch.stack(ws).transpose(1, 2)
        w32 = w32.reshape(k * fp, HIDDEN)
        library = lambda: torch.mm(da32, w32)  # noqa: E731
        dw_library = dw_yardstick(grad, h.reshape(rows, -1), da32)
    else:
        da_bytes = rows * k * f * 2
        gradient_bytes = in_bytes + rows * 4 + da_bytes
        dw_bytes = rows * HIDDEN * 2 + da_bytes + head_bytes
        w2 = grad.w.reshape(grad.w.shape[0], -1)
        library = lambda: torch.mm(grad.da, w2.T,  # noqa: E731
                                   out_dtype=torch.float32)
        dw_library = dw_yardstick(grad)
    results = {}
    for kernel, fn, plain_fn, library_fn, err, nbytes in (
        ("forward", lambda: ops.grouped_forward(*args, **kw), plain_forward,
         None, fwd_err, in_bytes + rows * 4),
        ("backward_gradient", lambda: gradient(*bargs),
         lambda: plain_gradient(*bargs), None, grad_err, gradient_bytes),
        ("backward_dh", lambda: fl.tc_dh(grad),
         lambda: fl.reference_tc_dh(grad), library, dh_err,
         da_bytes + k * HIDDEN * f * 4 + rows * HIDDEN * 4),
        ("backward_dw", lambda: fl.tc_dw(grad),
         lambda: fl.reference_tc_dw(grad), dw_library, dw_err, dw_bytes),
    ):
        t_bound, by = bound(nbytes, product, BF16_FLOPS)
        library_ms = None
        if library_fn is not None:
            try:  # bf16: torch.mm with a float32 output from bf16 operands
                library_ms = time_ms(library_fn, **timed)
            except (RuntimeError, TypeError) as err_:
                log(f"library call for {tag} {kernel}{sfx} unavailable: "
                    f"{err_}")
        results[f"{fam.prefix}_grouped_{kernel}{sfx}"] = {
            "max_abs_err": err, "ms": time_ms(fn, **timed),
            "plain_ms": time_ms(plain_fn, **timed), "bound_ms": t_bound,
            "bound_by": by, "library_ms": library_ms,
        }
    # the flat tensor-core kernels over the same G·M rows, targets cycling
    flat_gradient = fl.f32_tc_gradient if float32 else fl.tc_gradient
    flat_grad = flat_gradient(*flat_args)
    pairs = {
        "forward": (lambda: ops.grouped_forward(*args, **kw),
                    lambda: ops.fused_forward(name, h2, ws, bs, x, **kw)),
        "gradient": (lambda: gradient(*bargs),
                     lambda: flat_gradient(*flat_args)),
        "dh": (lambda: fl.tc_dh(grad), lambda: fl.tc_dh(flat_grad)),
        "dW": (lambda: fl.tc_dw(grad), lambda: fl.tc_dw(flat_grad)),
        "public backward": (lambda: ops.grouped_backward(*bargs, **kw),
                            lambda: ops.fused_backward(*flat_args, **kw)),
    }
    line = (f"grouped {fam.prefix}{sfx} G={n_groups} against the flat "
            f"kernels over {rows} cycled rows (ms): " + "; ".join(
                f"{label} {time_ms(a, **timed):.4f} vs "
                f"{time_ms(b, **timed):.4f}"
                for label, (a, b) in pairs.items()))
    if float32:
        line += ("; the float32 plain versions: forward "
                 f"{time_ms(lambda: ops.reference_grouped_forward(*args), **timed):.4f}"  # noqa: E501
                 ", backward "
                 f"{time_ms(lambda: (ops.reference_grouped_dh(*bargs), *ops.reference_grouped_dw(*bargs)), **timed):.4f}")  # noqa: E501
    print(line, flush=True)
    del flat_grad

    # the float32 gradient kernel with fewer W slots than planned
    # (restaged more often)
    if float32 and grad.plan["w_slots"] > 1:
        sweep = ["the planned slots "
                 f"{results[f'{fam.prefix}_grouped_backward_gradient{sfx}']['ms']:.4f}"]  # noqa: E501
        plan_fn = fl.grouped_tc_plan
        for slots in range(1, grad.plan["w_slots"]):
            def capped(*a, slots=slots, **kw_):
                plan = plan_fn(*a, **kw_)
                return dict(plan, w_slots=min(plan["w_slots"], slots))
            with replaced(fl, "grouped_tc_plan", capped):
                if not torch.equal(gradient(*bargs).da, grad.da):
                    raise AssertionError(f"{tag} float32 with {slots} W "
                                         "slots differs")
                sweep.append(f"{slots} W slots "
                             f"{time_ms(lambda: gradient(*bargs), **timed):.4f}")  # noqa: E501
        print(f"sweep {fam.prefix}_grouped{sfx} G={n_groups}, the gradient "
              f"kernel's W slots of {grad.plan['w_chunk']} rows (ms): "
              + "; ".join(sweep), flush=True)
    return results


def check_wide(x, g, gen):
    """Decoder width 1,024 (four hidden chunks): NB, ZINB and the
    constrained Poisson (bf16 h and float32 h) against their plain
    versions.  The base families'
    backward is checked in float32, where nothing rounds: with bf16 da the
    roundings that a different summation order flips grow with the
    activations and with the steepness of the gradient (ZINB's dW_p read
    8.4e-4 of its largest value at this width, 6.9e-5 at width 256), so a
    bf16 reading here would not isolate the hidden-chunk arithmetic."""
    from scvae_tpu_torch import ops

    bf16 = torch.bfloat16
    m, f = x.shape
    h = torch.relu(torch.randn(m, WIDE_HIDDEN, generator=gen, device=x.device))
    for name in ("negative binomial", "zero-inflated negative binomial"):
        ws, bs = head_weights(gen, len(ops.FAMILIES[name].heads), WIDE_HIDDEN,
                              f, x.device)
        for cdt in (bf16, None):
            check_close(f"{name} forward H={WIDE_HIDDEN} {cdt}",
                        ops.fused_forward(name, h, ws, bs, x,
                                          compute_dtype=cdt),
                        ops.reference_forward(name, h, ws, bs, x,
                                              compute_dtype=cdt),
                        FORWARD_RTOL)
        got = ops.fused_backward(name, g, h, ws, bs, x)
        want = ops.reference_backward(name, g, h, ws, bs, x)
        for i, (a, b) in enumerate(zip(got, want)):
            check_close(f"{name} backward float32 [{i}] H={WIDE_HIDDEN}", a,
                        b, AUTOGRAD_RTOL)
    # the constrained Poisson, float32 h (three bf16 terms of h, W and da)
    # and bf16 h (two of W and da), each against the float32 plain versions
    (w,), (b,) = head_weights(gen, 1, WIDE_HIDDEN, f, x.device)
    n = x.float().sum(-1)
    for hh in (h, h.to(bf16)):
        hv = hh.float()
        ll_ref, lse_ref = ops.reference_cp_forward(hv, w, b, x, n)
        want = (ops.reference_cp_dh(g, hv, w, b, x, lse_ref),
                *ops.reference_cp_dw(g, hv, w, b, x, lse_ref))
        ll, lse = ops.cp_forward(hh, w, b, x, n)
        check_close(f"cp_forward H={WIDE_HIDDEN} h={hh.dtype}", ll, ll_ref,
                    FORWARD_RTOL)
        got = ops.cp_backward(g, hh, w, b, x, lse)
        for i, (a, b_ref) in enumerate(zip(got, want, strict=True)):
            check_close(f"cp_backward [{i}] H={WIDE_HIDDEN} h={hh.dtype}", a,
                        b_ref, AUTOGRAD_RTOL)


def phase_kernels(counts_dev, card):
    """Each kernel against its plain version at the headline shapes, and
    the gene split's block launches (``check_gene_blocks``)."""
    from scvae_tpu_torch import ops

    dev = counts_dev.device
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    n = counts_dev.shape[0]
    idx = torch.randperm(n, generator=gen, device=dev)[:BATCH].to(torch.int32)
    x, results = check_gather(counts_dev, idx, flush)
    results = {"gather_rows": results}
    # decoder output and row cotangents shared by every family
    h = torch.relu(torch.randn(BATCH, HIDDEN, generator=gen, device=dev))
    g = torch.randn(BATCH, generator=gen, device=dev) / BATCH
    for name in ops.FAMILIES:
        results.update(check_family(name, h, g, x, gen, flush))
    results.update(check_cp(h, g, x, gen, flush))
    for name, k_max in CATEGORISED:
        results.update(check_categorised(name, k_max, h, g, x, gen, flush))
    results.update(check_cycled_rows(x, gen, flush))
    for name in BASE_FAMILIES:
        results.update(check_grouped(name, x, gen, flush, CLUSTERS))
        check_grouped(name, x, gen, flush, GROUP_CAP)
    results.update(check_over_budget_genes(g, gen, flush))
    check_gene_blocks(x, gen, flush, card)
    check_wide(x, g, gen)
    check_lfm_widths(x, flush)
    torch.cuda.synchronize()
    return results


def phase_small_step(label, model, name, k_max, options=None):
    """One training loss and its gradients from the same small input on the
    CPU (plain versions) and on the GPU (kernels, or the unfused path, with
    ``options`` of the configuration), float32."""
    from scvae_tpu_torch.models import gmvae, step, vae
    from scvae_tpu_torch.ops import lgamma

    kwargs = dict(feature_size=300, latent_size=8, hidden_sizes=(32, 32),
                  reconstruction_distribution=name,
                  number_of_reconstruction_classes=k_max, precision="float32",
                  **(options or {}))
    rng = np.random.RandomState(0)
    x = rng.poisson(1.5, size=(64, 300)).astype(np.float32)
    batch_indices = rng.randint(0, N_BATCHES, size=(64, 1)).astype(np.float32)
    if model == "gmvae":
        module = gmvae
        config = gmvae.GMVAEConfig(number_of_latent_clusters=4, **kwargs)
        noise = rng.standard_normal((1, 4, 64, 8)).astype(np.float32)
    else:
        module = vae
        config = vae.VAEConfig(**kwargs)
        noise = rng.standard_normal((1, 64, 8)).astype(np.float32)
    if k_max:  # every other row Poisson(K): the base branch (t ≥ K) runs
        x[1::2] = rng.poisson(k_max, size=(32, 300))
    params, state = module.init(config, torch.Generator().manual_seed(0))
    results = []
    for device in ("cpu", "cuda"):
        p = step.tree_map(
            lambda a: a.detach().to(device).requires_grad_(True), params)
        s = step.tree_map(lambda a: a.to(device), state)
        xt = torch.from_numpy(x).to(device)
        count_sum = xt.sum(-1, keepdim=True)
        batch = {"x": xt, "t": option_targets(name, xt),
                 "t_lgamma_rowsum": torch.sum(lgamma(1.0 + xt), dim=-1),
                 "count_sum": count_sum,
                 "count_sum_feature": count_sum / count_sum.max(),
                 "batch_indices": torch.from_numpy(batch_indices).to(device)}
        loss, _ = module.loss_fn(config, p, s, batch, None,
                                 noise=torch.from_numpy(noise).to(device))
        grads = torch.autograd.grad(loss, step.tree_leaves(p))
        results.append([loss.detach().cpu()] + [gr.cpu() for gr in grads])
    (cpu_loss, *cpu_grads), (gpu_loss, *gpu_grads) = results
    check_close(f"small step loss ({label})", gpu_loss, cpu_loss,
                AUTOGRAD_RTOL)
    largest = max(float(g.abs().max()) for g in cpu_grads)
    for i, (a, b) in enumerate(zip(gpu_grads, cpu_grads)):
        check_close(f"small step gradient [{i}] ({label})", a, b,
                    AUTOGRAD_RTOL, scale=largest)


def train_config_level(config, counts, epoch_callback=None, device="cuda",
                       capture=True, epochs=EPOCHS, streamed=False):
    """Train a VAE or GMVAE ``config`` on ``device`` through the config-level
    functions (``models/step.py`` and the training loop on the API's staged
    data, writing no files), as the JAX package's ``bench.py`` config 3
    trains VAE-ZINB-cat, which both packages' VAE API refuses; the epoch's
    ELBO is the mean of its training minibatches'.  ``capture=False`` runs
    the steps eagerly on CUDA too (phase 4b's comparison).  ``streamed``
    feeds the steps from the host through the API's streaming pieces
    (``BatchPipeline`` with the narrow count dtypes and the CSR wire, the
    per-batch ``make_train_step``, ``streaming_epoch_runner``) instead."""
    from scvae_tpu_torch.data.dataset import DataSet
    from scvae_tpu_torch.data.pipeline import (
        BatchPipeline,
        build_model_arrays,
        device_resident_data,
    )
    from scvae_tpu_torch.models import api, gmvae, step, training, vae

    module = gmvae if isinstance(config, gmvae.GMVAEConfig) else vae
    dev = torch.device(device)
    n_cells = counts.shape[0]
    arrays = build_model_arrays(
        DataSet("in-memory", values=counts),
        use_count_sum_as_parameter=config.use_count_sum_as_parameter)
    optimizer = step.make_optimizer(config.learning_rate)
    params, state = (step.tree_map(lambda a: a.to(dev), tree) for tree in
                     module.init(config, torch.Generator().manual_seed(0)))

    def loss(params, model_state, batch, generator, warm_up_weight,
             shard=None):
        return module.loss_fn(config, params, model_state, batch, generator,
                              warm_up_weight=warm_up_weight, shard=shard)

    if streamed:
        def pipeline(epoch):
            return BatchPipeline(arrays, BATCH, seed=epoch,
                                 count_dtype=api.VariationalAutoencoder
                                 .DEVICE_COUNT_DTYPES, device=dev)

        run_epoch = training.streaming_epoch_runner(
            step.make_train_step(loss, optimizer, capture=capture), pipeline)
        steps = -(-n_cells // BATCH)
    else:
        data = api._append_lgamma_rowsum(
            device_resident_data(arrays, device=dev), config)
        train_epoch = step.make_train_epoch(
            loss, optimizer,
            batch_dtypes=api._bf16_batch_dtypes(arrays, config, dev),
            capture=capture)
        run_epoch = training.device_epoch_runner(train_epoch, data, n_cells,
                                                 BATCH, seed=0)
        steps = n_cells // BATCH
    return training.run_training_loop(
        train_state=step.create_train_state(params, state, optimizer),
        run_epoch=run_epoch,
        evaluate_training=None, number_of_epochs=epochs,
        generator=torch.Generator(device=dev).manual_seed(0),
        steps_per_epoch=steps,
        number_of_warm_up_epochs=config.number_of_warm_up_epochs,
        verbose=False, epoch_callback=epoch_callback)


def set_rows(data) -> int:
    """The rows of a training or validation set: a ``DataSet`` or a
    matrix."""
    return (data.number_of_examples if hasattr(data, "number_of_examples")
            else data.shape[0])


def evaluation_batches(sets, epochs=EPOCHS) -> int:
    """The batches of ``train``'s per-epoch evaluations of ``sets`` over
    ``epochs`` epochs: each set in minibatches of BATCH, its remainder a
    batch of its own."""
    return epochs * sum(-(-set_rows(data) // BATCH) for data in sets)


def train_config(label, model, name, k_max, counts, card, precision=None):
    """One trained configuration at the headline width for two epochs
    (``precision`` None: the API's default); returns the kernel launches
    of the run."""
    from scvae_tpu_torch import (
        GaussianMixtureVariationalAutoencoder,
        VariationalAutoencoder,
        ops,
    )

    phase_small_step(label, "vae" if model == "config" else model, name,
                     k_max)
    kwargs = dict(feature_size=N_GENES, latent_size=LATENT,
                  hidden_sizes=[HIDDEN, HIDDEN],
                  reconstruction_distribution=name,
                  number_of_reconstruction_classes=k_max,
                  log_directory=os.path.join(SLICE_DIRECTORY, label))
    if precision is not None:
        kwargs["precision"] = precision
    ops.reset_launch_counts()
    if model == "config":
        result = train_config_level(
            trained_config(model, name, k_max, precision), counts)
    else:
        if model == "gmvae":
            model_ = GaussianMixtureVariationalAutoencoder(
                number_of_latent_clusters=CLUSTERS, **kwargs)
        else:
            model_ = VariationalAutoencoder(**kwargs)
        result = model_.train(counts, number_of_epochs=EPOCHS,
                              minibatch_size=BATCH, seed=0, device="cuda",
                              verbose=False)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    steps = result.steps_per_epoch * EPOCHS
    prefix = ("cp" if name == "constrained poisson"
              else ops.FAMILIES[name].prefix)
    prefix = f"cat_{prefix}" if k_max else prefix
    # the backward: its gradient kernel, then the dh and dW products; the
    # float32 kernels count with the "_float32" suffix
    kernels = ["forward", "backward_gradient", "backward_dh", "backward_dw"]
    suffix = "_float32" if precision == "float32" else ""
    ours = {f"{prefix}_{kernel}{suffix}" for kernel in kernels}
    # a VAE's per-epoch evaluation: the float32 forward once a batch
    evaluated = ({f"{prefix}_forward_float32": evaluation_batches([counts])}
                 if model == "vae" else {})
    for kernel, count in launches.items():
        want = (steps if kernel in ours else 0) + evaluated.get(kernel, 0)
        if kernel != "gather_rows" and count != want:
            raise AssertionError(f"{label}: {kernel} launched {count} times "
                                 f"in {steps} training steps and "
                                 f"{evaluated.get(kernel, 0)} evaluation "
                                 f"batches (want {want})")
    if launches["gather_rows"] < steps:
        raise AssertionError(f"{label}: gather_rows launched "
                             f"{launches['gather_rows']} times in {steps} "
                             "training steps")
    elbo = result.history["training"]["lower_bound"]
    if not (np.all(np.isfinite(elbo)) and elbo[-1] > elbo[0]):
        raise AssertionError(f"{label}: training ELBO not finite and rising: "
                             f"{elbo}")
    seconds = result.epoch_seconds[-1]
    RATES[label] = result.steps_per_epoch / seconds
    print(f"slice {label}: ELBO {elbo}; epoch {EPOCHS}: "
          f"{result.steps_per_epoch / seconds:.6g} steps/s, "
          f"{result.steps_per_epoch * BATCH / seconds:.6g} cells/s; "
          f"launches {({k: v for k, v in launches.items() if v})} ({card})",
          flush=True)
    return launches


def trained_config(model, name, k_max, precision, options=None):
    """The configuration of a phase 4 or 4b run: the headline VAE, or the
    GMVAE API's configuration (10 clusters), with ``options``."""
    from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder
    from scvae_tpu_torch.models import vae

    kwargs = dict(feature_size=N_GENES, latent_size=LATENT,
                  hidden_sizes=(HIDDEN, HIDDEN),
                  reconstruction_distribution=name,
                  number_of_reconstruction_classes=k_max, **(options or {}))
    if precision is not None:
        kwargs["precision"] = precision
    if model == "gmvae":
        return GaussianMixtureVariationalAutoencoder(
            number_of_latent_clusters=CLUSTERS, **kwargs).config
    return vae.VAEConfig(**kwargs)


# Phase 4a: the main path under ``utils.profiling.trace``.  Each kernel
# name part of the trace and the launch counters of the kernels it names.
TRACE_DIRECTORY = os.path.join(BUILD, "trace")
TRACED_KERNELS = {
    # K2, K3, and the evaluation's float32 K2 (on the same heads kernel)
    "tc_heads_kernel": ("nb_forward", "nb_backward_gradient",
                        "nb_forward_float32"),
    "tc_product_kernel": ("nb_backward_dh", "nb_backward_dw"),  # K3
    "gather_vector_kernel": ("gather_rows",),  # K1
}
TRACE_TOP = 30


def phase_trace(counts, card):
    """Phase 4a: the headline VAE-NB through ``train`` for two epochs, with
    the span recorder on and ``trace`` around epoch 2; then
    ``summarize_trace`` of the trace holds each of TRACED_KERNELS by name,
    its count equal to the launches the counters took in that epoch, and
    the ``epoch.train`` span; the ``epoch.train`` spans equal the loop's
    ``epoch_seconds`` within 1 ms an epoch; ``device_memory_stats`` reads
    0 < bytes in use ≤ the limit.  Returns the run's launches."""
    from scvae_tpu_torch import VariationalAutoencoder, ops
    from scvae_tpu_torch.utils import tracing
    from scvae_tpu_torch.utils.profiling import (
        device_memory_stats,
        summarize_trace,
        trace,
    )

    start = time.perf_counter()
    shutil.rmtree(TRACE_DIRECTORY, ignore_errors=True)
    traces = os.path.join(TRACE_DIRECTORY, "trace")
    model = VariationalAutoencoder(
        feature_size=N_GENES, latent_size=LATENT,
        hidden_sizes=[HIDDEN, HIDDEN],
        reconstruction_distribution="negative binomial",
        log_directory=os.path.join(TRACE_DIRECTORY, "model"))
    window = {}
    profiling = contextlib.ExitStack()

    def callback(epoch, train_state, metrics):
        if epoch == 0:
            window["before"] = ops.launch_counts()
            profiling.enter_context(trace(traces))
        else:
            profiling.close()
            window["after"] = ops.launch_counts()

    ops.reset_launch_counts()
    tracing.reset()
    tracing.enable()
    try:
        with profiling:
            result = model.train(counts, number_of_epochs=EPOCHS,
                                 minibatch_size=BATCH, seed=0,
                                 device="cuda", verbose=False,
                                 epoch_callback=callback)
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    spans = tracing.spans()
    trained = [span.seconds for span in spans if span.name == "epoch.train"]
    if len(trained) != EPOCHS or any(
            abs(a - b) > 1e-3 for a, b in zip(trained, result.epoch_seconds)):
        raise AssertionError(f"trace: epoch.train spans {trained} s against "
                             f"epoch seconds {result.epoch_seconds}")
    launches = ops.launch_counts()
    traced = {name: window["after"].get(name, 0)
              - window["before"].get(name, 0) for name in window["after"]}
    if traced["nb_forward"] != result.steps_per_epoch:
        raise AssertionError(f"trace: nb_forward launched "
                             f"{traced['nb_forward']} times in epoch 2's "
                             f"{result.steps_per_epoch} steps")
    entries = summarize_trace(traces, top=None)
    if not any(entry["name"] == "epoch.train" for entry in entries):
        raise AssertionError("trace: no epoch.train annotation")
    for part, counters in TRACED_KERNELS.items():
        found = [(rank, entry) for rank, entry in enumerate(entries)
                 if part in entry["name"]]
        count = sum(entry["count"] for _, entry in found)
        want = sum(traced[name] for name in counters)
        if not found or count != want:
            raise AssertionError(f"trace: {part} {count} times in the "
                                 f"trace, {want} launches counted "
                                 f"({', '.join(counters)})")
        ranks = [rank + 1 for rank, _ in found]
        print(f"trace: {part} {count} events (launches "
              f"{ {name: traced[name] for name in counters} }), "
              f"{sum(entry['total_ms'] for _, entry in found):.4f} ms, "
              f"ranks {ranks} of {len(entries)} (in the top {TRACE_TOP}: "
              f"{max(ranks) <= TRACE_TOP})", flush=True)
    memory = device_memory_stats()
    if not all(0 < entry["bytes_in_use"] <= entry["bytes_limit"]
               for entry in memory):
        raise AssertionError(f"trace: device memory {memory}")
    per_epoch = collections.defaultdict(list)
    for span in spans:
        if span.name.startswith("epoch."):
            per_epoch[span.name].append(round(span.seconds, 4))
    print(f"trace: VAE-NB, {EPOCHS} epochs of {result.steps_per_epoch} "
          f"steps, epoch 2 traced; spans (s an epoch) {dict(per_epoch)}; "
          f"epoch seconds {[round(s, 4) for s in result.epoch_seconds]}; "
          f"memory {memory}; phase {time.perf_counter() - start:.1f} s "
          f"({card})", flush=True)
    print("trace top: " + json.dumps(entries[:10]), flush=True)
    return launches


def phase_graph_vs_eager(data, card):
    """Phase 4b: each GRAPHED configuration trained for two epochs from the
    same seed through ``train_config_level``, eagerly and then through the
    CUDA graphs, in this process: the same kernel launches, the parameters
    within GRAPH_PARAM_RTOL of the largest |parameter| and the curves
    within GRAPH_CURVE_RTOL; both runs' steps/s of epoch 2."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.models import step

    for label, model, name, k_max, mean, precision, options in GRAPHED:
        config = trained_config(model, name, k_max, precision, options)
        runs = {}
        for capture in (False, True):
            ops.reset_launch_counts()
            result = train_config_level(config, data[mean], capture=capture,
                                        streamed=label.endswith("-stream"))
            torch.cuda.synchronize()
            runs[capture] = (result, ops.launch_counts())
        (eager, eager_launches), (graphed, graphed_launches) = (
            runs[False], runs[True])
        if graphed_launches != eager_launches:
            raise AssertionError(f"graph {label}: launches "
                                 f"{graphed_launches}, eagerly "
                                 f"{eager_launches}")
        pairs = [(a, b) for part in ("params", "model_state")
                 for a, b in zip(
                     step.tree_leaves(getattr(eager.train_state, part)),
                     step.tree_leaves(getattr(graphed.train_state, part)))]
        pairs.append((eager.train_state.opt_state["count"],
                      graphed.train_state.opt_state["count"]))
        largest = max(float(a.abs().max()) for a, _ in pairs)
        diff = max(float((a.double() - b.double()).abs().max())
                   for a, b in pairs)
        curve_e = np.asarray(eager.history["training"]["lower_bound"])
        curve_g = np.asarray(graphed.history["training"]["lower_bound"])
        curve_rel = float(np.max(np.abs(curve_g - curve_e) / np.abs(curve_e)))
        exact = diff == 0 and np.array_equal(curve_e, curve_g)
        rates = [result.steps_per_epoch / result.epoch_seconds[-1]
                 for result in (eager, graphed)]
        print(f"graph {label}: epoch 2 {rates[0]:.6g} steps/s eager, "
              f"{rates[1]:.6g} graphed ({rates[1] / rates[0]:.3g}x); curve "
              f"eager {curve_e.tolist()}, graphed {curve_g.tolist()}; "
              f"largest parameter difference {diff:.3g} over largest "
              f"|parameter| {largest:.6g} = {diff / largest:.3g}, curves "
              f"{curve_rel:.3g} relative; "
              f"{'bit for bit' if exact else 'not bit for bit'} ({card})",
              flush=True)
        if diff > GRAPH_PARAM_RTOL * largest or curve_rel > GRAPH_CURVE_RTOL:
            raise AssertionError(f"graph {label}: parameters "
                                 f"{diff / largest:.3g}, curves "
                                 f"{curve_rel:.3g} from the eager run")


def option_targets(name, x):
    """The targets a likelihood trains on, from counts ``x``: gamma's are
    x + 1 (zero is outside its support), Bernoulli's x binarised."""
    if name == "gamma":
        return x + 1.0
    if name == "bernoulli":
        return (x > 0).to(x.dtype)
    return x


def options_data(kind, data):
    """Phase 4d's training set of ``kind`` from phase 4's counts ``data``
    (by Poisson mean): the headline counts; Poisson(30) + 1 counts; the
    headline counts with N_BATCHES batch indices from RandomState(3); a
    data set of them binarised (a Bernoulli model's targets); the counts +
    1 (dense); their first MVG_GENES genes."""
    from scvae_tpu_torch import DataSet

    counts = data[3.0]
    if kind == "counts":
        return counts
    if kind == "counts30":
        return data[30.0]
    if kind == "batches":
        indices = np.random.RandomState(3).randint(0, N_BATCHES,
                                                   counts.shape[0])
        return DataSet("in-memory", values=counts, batch_indices=indices)
    if kind == "binarised":
        data_set = DataSet("in-memory", values=counts)
        data_set.binarise()
        return data_set
    if kind == "counts_plus_one":
        return counts.toarray() + np.float32(1.0)
    if kind == "first_genes":
        return counts[:, :MVG_GENES]
    raise ValueError(kind)


def check_lfm_widths(x, flush):
    """NB's K2 and K3's three kernels (bf16) at the LFM decoder's widths
    LFM_WIDTHS, which the heads kernels pad to a multiple of 8, against
    their plain versions at phase 3's tolerances: the forward; the gradient
    kernel's bf16(da) and db row-tile sums; the dh and dW products of the
    kernel's da; the public backward as a whole, bf16 and float32.  h is
    the LFM's decoder input, not a ReLU's output: standard normal.  The
    draws come from a generator of their own."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import fused_likelihood as fl

    name, bf16 = "negative binomial", torch.bfloat16
    m, f = x.shape
    gen = torch.Generator(device=x.device).manual_seed(17)
    g = torch.randn(m, generator=gen, device=x.device) / m
    for width in LFM_WIDTHS:
        h = torch.randn(m, width, generator=gen, device=x.device)
        ws, bs = head_weights(gen, 2, width, f, x.device)
        tag = f"nb H={width} (LFM)"
        fwd_args = (name, h, ws, bs, x)
        bwd_args = (name, g, h, ws, bs, x)

        def forward():
            return ops.fused_forward(*fwd_args, compute_dtype=bf16,
                                     include_lgamma_const=False)

        check_close(f"{tag} forward", forward(),
                    ops.reference_forward(*fwd_args, compute_dtype=bf16,
                                          include_lgamma_const=False),
                    FORWARD_RTOL)
        grad = fl.tc_gradient(*bwd_args)
        plain = fl.reference_tc_gradient(*bwd_args)
        check_bf16_steps(f"{tag} backward_gradient bf16(da)", grad.da,
                         plain.da)
        check_close(f"{tag} backward_gradient db row-tile sums",
                    grad.db_parts, plain.db_parts, PRODUCT_RTOL)
        check_close(f"{tag} backward_dh of the kernel's da", fl.tc_dh(grad),
                    fl.reference_tc_dh(grad), PRODUCT_RTOL)
        for i, (a, b) in enumerate(zip(fl.tc_dw(grad),
                                       fl.reference_tc_dw(grad),
                                       strict=True)):
            check_close(f"{tag} backward_dw [{i}] of the kernel's da", a, b,
                        PRODUCT_RTOL)
        for cdt, rtol in ((bf16, BACKWARD_RTOL), (None, AUTOGRAD_RTOL)):
            got = ops.fused_backward(*bwd_args, compute_dtype=cdt)
            want = ops.reference_backward(*bwd_args, compute_dtype=cdt)
            for i, (a, b) in enumerate(zip(got, want)):
                check_close(f"{tag} backward {cdt} [{i}]", a, b, rtol)

        def backward():
            return ops.fused_backward(*bwd_args, compute_dtype=bf16)

        print(f"lfm width {width} (padded {fl.tc_padded(width)}): forward "
              f"{time_ms(forward, flush=flush):.4f} ms, backward "
              f"{time_ms(backward, flush=flush):.4f} ms", flush=True)


def check_fused_unfused(counts):
    """One training loss of the headline VAE-NB and its gradients on the
    same parameters, rows and z noise, on the fused kernels and on the
    unfused path, with bf16 matmul inputs (the default on the card) and in
    float32: the loss within FUSED_UNFUSED_RTOL relative; the gradients
    within FUSED_UNFUSED_RTOL of the largest |gradient| in float32, and
    within BF16_GRADIENT_NORM_RTOL in norm with bf16 inputs."""
    from scvae_tpu_torch.models import step, vae

    rows = np.random.RandomState(4).choice(counts.shape[0], BATCH,
                                           replace=False)
    x = torch.from_numpy(counts[np.sort(rows)].toarray()).cuda()
    generator = torch.Generator(device="cuda").manual_seed(2)
    noise = torch.randn((1, BATCH, LATENT), device="cuda",
                        generator=generator)
    for precision in ("bfloat16", "float32"):
        configs = [vae.VAEConfig(
            feature_size=N_GENES, latent_size=LATENT,
            hidden_sizes=(HIDDEN, HIDDEN),
            reconstruction_distribution="negative binomial",
            fused_likelihood=fused, precision=precision)
            for fused in (None, False)]
        params, state = vae.init(configs[0],
                                 torch.Generator().manual_seed(1))
        results = []
        for config in configs:
            p = step.tree_map(lambda a: a.cuda().requires_grad_(True), params)
            s = step.tree_map(lambda a: a.cuda(), state)
            loss, _ = vae.loss_fn(config, p, s, {"x": x, "t": x}, None,
                                  noise=noise)
            grads = torch.autograd.grad(loss, step.tree_leaves(p))
            results.append((loss.detach(), torch.cat(
                [gr.reshape(-1) for gr in grads])))
        (fused_loss, fused_grads), (loss, grads) = results
        tag = f"VAE-NB {precision}"
        check_close(f"{tag} loss fused against unfused", fused_loss, loss,
                    FUSED_UNFUSED_RTOL)
        largest = float(grads.abs().max())
        worst = max_err(fused_grads, grads)
        norm = float(torch.linalg.vector_norm(fused_grads - grads)
                     / torch.linalg.vector_norm(grads))
        print(f"fused against unfused {tag}: loss {float(fused_loss):.8g} / "
              f"{float(loss):.8g}; gradients: largest difference "
              f"{worst:.3g} = {worst / largest:.3g} of the largest "
              f"|gradient| {largest:.4g}, ‖Δ‖/‖g‖ {norm:.3g}",
              flush=True)
        if precision == "float32":
            check_close(f"{tag} gradients fused against unfused", fused_grads,
                        grads, FUSED_UNFUSED_RTOL)
        elif not norm <= BF16_GRADIENT_NORM_RTOL:
            raise AssertionError(f"{tag}: gradients fused against unfused "
                                 f"{norm} in norm (limit "
                                 f"{BF16_GRADIENT_NORM_RTOL})")


def check_covariances(label, directory):
    """Every epoch's prior covariance matrices in ``centroids.json``:
    symmetric and positive definite."""
    from scvae_tpu_torch.models import checkpoints

    covariances = checkpoints.load_centroids(directory)["covariance_matrices"]
    covariances = np.asarray(covariances, np.float64)  # (E, K, D, D)
    asymmetry = float(np.abs(covariances - np.swapaxes(covariances, -1, -2))
                      .max())
    smallest = float(np.linalg.eigvalsh(covariances).min())
    print(f"options {label}: centroids.json covariance matrices "
          f"{covariances.shape}, asymmetry {asymmetry:.3g}, smallest "
          f"eigenvalue {smallest:.4g}", flush=True)
    if asymmetry > 1e-6 * float(np.abs(covariances).max()) or smallest <= 0:
        raise AssertionError(f"{label}: covariance matrices are not "
                             "symmetric positive definite")


def phase_options(data, card):
    """Phase 4d: fused against unfused on one headline step, then each
    OPTIONS configuration trained through the API at the headline width
    for two epochs into an emptied directory under ``build/``: one small
    step on the CPU and the card first (phase 4's), then a finite ELBO
    that rises from epoch 1 to 2, K1 at least once a step, NB's K2 and
    K3's three kernels once a step on the fused configurations (a fused
    VAE's float32 K2 besides once a batch of its per-epoch evaluations)
    and no likelihood kernel on the unfused ones; GMVAE-NB-full's prior
    covariances symmetric positive definite.  Returns the launches, by
    the kernels line's entries (a GMVAE's NB kernels are the cycled
    ones)."""
    from scvae_tpu_torch import (
        GaussianMixtureVariationalAutoencoder,
        VariationalAutoencoder,
        ops,
    )

    check_fused_unfused(data[3.0])
    shutil.rmtree(OPTIONS_DIRECTORY, ignore_errors=True)
    nb = {f"nb_{kernel}" for kernel in ("forward", "backward_gradient",
                                        "backward_dh", "backward_dw")}
    total = collections.Counter()
    for label, model, name, k_max, kind, options, fused in OPTIONS:
        phase_small_step(label, model, name, k_max, options)
        training_set = options_data(kind, data)
        features = MVG_GENES if kind == "first_genes" else N_GENES
        kwargs = dict(feature_size=features, latent_size=LATENT,
                      hidden_sizes=[HIDDEN, HIDDEN],
                      reconstruction_distribution=name,
                      number_of_reconstruction_classes=k_max,
                      log_directory=os.path.join(OPTIONS_DIRECTORY, label),
                      **options)
        if model == "gmvae":
            model_ = GaussianMixtureVariationalAutoencoder(
                number_of_latent_clusters=CLUSTERS, **kwargs)
        else:
            model_ = VariationalAutoencoder(**kwargs)
        ops.reset_launch_counts()
        result = model_.train(training_set, number_of_epochs=EPOCHS,
                              minibatch_size=BATCH, seed=0, device="cuda",
                              verbose=False)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        steps = result.steps_per_epoch * EPOCHS
        # a fused VAE's per-epoch evaluation: the float32 forward a batch
        evaluated = (evaluation_batches([training_set])
                     if fused and model == "vae" else 0)
        for kernel, count in launches.items():
            want = ((steps if fused and kernel in nb else 0)
                    + (evaluated if kernel == "nb_forward_float32" else 0))
            if kernel != "gather_rows" and count != want:
                raise AssertionError(f"{label}: {kernel} launched {count} "
                                     f"times in {steps} training steps and "
                                     f"{evaluated} evaluation batches "
                                     f"(want {want})")
        if launches["gather_rows"] < steps:
            raise AssertionError(f"{label}: gather_rows launched "
                                 f"{launches['gather_rows']} times in "
                                 f"{steps} training steps")
        elbo = result.history["training"]["lower_bound"]
        if not (np.all(np.isfinite(elbo)) and elbo[-1] > elbo[0]):
            raise AssertionError(f"{label}: training ELBO not finite and "
                                 f"rising: {elbo}")
        seconds = result.epoch_seconds[-1]
        RATES[label] = result.steps_per_epoch / seconds
        print(f"options {label}: ELBO {elbo}; epoch {EPOCHS}: "
              f"{RATES[label]:.6g} steps/s, "
              f"{result.steps_per_epoch * BATCH / seconds:.6g} cells/s; "
              f"{'fused' if fused else 'unfused'}; launches "
              f"{({k: v for k, v in launches.items() if v})} ({card})",
              flush=True)
        if "latent_distribution" in options:
            check_covariances(label, model_.log_directory())
        for kernel, count in launches.items():
            total[kernel + "_cycled" if model == "gmvae" and kernel != (
                "gather_rows") else kernel] += count
    print(f"options: epoch {EPOCHS} VAE-NB-unfused "
          f"{RATES['VAE-NB-unfused']:.6g} steps/s, VAE-NB (phase 4) "
          f"{RATES['negative binomial']:.6g} steps/s ({card})", flush=True)
    return total


def split_counts(counts):
    """Phase 5's split: (training rows, validation rows), 90/10."""
    order = np.random.RandomState(1).permutation(counts.shape[0])
    n_valid = int(counts.shape[0] * VALIDATION_SHARE)
    return counts[order[n_valid:]], counts[order[:n_valid]]


def phase_deferred(counts, card):
    """Phase 4c: VAE-NB on phase 5's split with validation for three
    epochs, once with ``metrics_fetch="sync"`` and once "deferred": the
    same curves (1e-6 relative), the same epochs trained and best epoch,
    and the same epochs in the files of the run, ``best/`` and
    ``early_stopping/``."""
    from scvae_tpu_torch import VariationalAutoencoder
    from scvae_tpu_torch.models import checkpoints

    shutil.rmtree(DEFERRED_DIRECTORY, ignore_errors=True)
    train, valid = split_counts(counts)
    runs = {}
    for mode in ("sync", "deferred"):
        model = VariationalAutoencoder(
            feature_size=N_GENES, latent_size=LATENT,
            hidden_sizes=[HIDDEN, HIDDEN],
            reconstruction_distribution="negative binomial",
            log_directory=os.path.join(DEFERRED_DIRECTORY, mode))
        result = model.train(train, valid, number_of_epochs=AFTER_EPOCHS,
                             minibatch_size=BATCH, seed=0, device="cuda",
                             verbose=False, metrics_fetch=mode)
        directory = model.log_directory()
        epochs = {
            version: checkpoints.load_metadata(path)["epoch"]
            for version in ("run", "best", "early_stopping")
            for path in [directory if version == "run"
                         else os.path.join(directory, version)]
            if checkpoints.checkpoint_exists(path)}
        runs[mode] = (result, epochs)
    (sync, sync_epochs), (deferred, deferred_epochs) = (runs["sync"],
                                                        runs["deferred"])
    worst = 0.0
    for kind in ("training", "validation"):
        for name, want in sync.history[kind].items():
            got = np.asarray(deferred.history[kind][name])
            want = np.asarray(want)
            if got.shape != want.shape:
                raise AssertionError(f"deferred {kind} {name}: {got} vs {want}")
            worst = max(worst, float(np.max(np.abs(got - want)
                                            / np.abs(want))))
    print(f"deferred VAE-NB: ELBO(valid) sync "
          f"{sync.history['validation']['lower_bound']}, deferred "
          f"{deferred.history['validation']['lower_bound']}; curves "
          f"{worst:.3g} relative; epochs in the files {deferred_epochs} "
          f"(sync {sync_epochs}); epoch seconds sync "
          f"{[round(t, 4) for t in sync.epoch_seconds]}, deferred "
          f"{[round(t, 4) for t in deferred.epoch_seconds]} ({card})",
          flush=True)
    if worst > GRAPH_CURVE_RTOL:
        raise AssertionError(f"deferred curves {worst:.3g} from sync")
    if ((deferred.number_of_epochs_trained, deferred.best_epoch,
         deferred_epochs) != (sync.number_of_epochs_trained, sync.best_epoch,
                              sync_epochs)):
        raise AssertionError(
            f"deferred run: {deferred.number_of_epochs_trained} epochs, best "
            f"{deferred.best_epoch}, files {deferred_epochs}; sync "
            f"{sync.number_of_epochs_trained}, {sync.best_epoch}, "
            f"{sync_epochs}")


def host_free_bytes() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as meminfo:
        for line in meminfo:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def over_budget_counts():
    """The over-budget set, built in O(nnz) without a sort: each row's 286
    columns are the start column plus multiples of 17 (coprime with 4,096,
    so unique), unsorted; values Poisson(3) + 1, float32 (a float32 /
    int32 CSR matrix, which the native densify reads without copies)."""
    import scipy.sparse

    rng = np.random.default_rng(0)
    nnz = int(OVER_GENES * 0.07)
    offsets = (np.arange(nnz, dtype=np.int32) * 17) % OVER_GENES
    cols = rng.integers(0, OVER_GENES, size=(OVER_CELLS, 1), dtype=np.int32)
    cols = (cols + offsets[None, :]) % OVER_GENES
    values = rng.poisson(3.0, size=cols.size).astype(np.float32)
    values += 1.0
    indptr = np.arange(OVER_CELLS + 1, dtype=np.int64) * nnz
    return scipy.sparse.csr_matrix((values, cols.reshape(-1), indptr),
                                   shape=(OVER_CELLS, OVER_GENES))


class StreamProbe:
    """Timings of the streaming path while it runs, by wrapping its
    pieces: the host's seconds per batch building it (the native densify,
    or the CSR wire's COO block) and placing it (the pinned buffers and the
    copies' launch); for each training step, the host's seconds in the
    step's call, whether it was a replay or a capture, and a replay's
    device milliseconds (events around the graph's replay); the placement
    each ``train`` chose and the fetch mode each training loop ran."""

    def __init__(self):
        self.host, self.place, self.steps, self.setup = [], [], [], []
        self.placements, self.fetch_modes = [], []
        self._step = None

    @contextlib.contextmanager
    def watching(self):
        from scvae_tpu_torch.data import pipeline
        from scvae_tpu_torch.models import api, step, training

        probe = self
        setup = pipeline.BatchPipeline.__init__
        host_batch = pipeline.BatchPipeline._host_batch
        to_device = pipeline.BatchPipeline._to_device
        train_step = step.TrainStep.__call__
        graphed = step._GraphedBody.__call__
        choose = api.VariationalAutoencoder._choose_device_placement
        loop = training.run_training_loop

        def timed_setup(self, *args, **kwargs):
            start = time.perf_counter()
            setup(self, *args, **kwargs)
            probe.setup.append(time.perf_counter() - start)

        def timed_host_batch(self, idx):
            start = time.perf_counter()
            out = host_batch(self, idx)
            probe.host.append(time.perf_counter() - start)
            return out

        def timed_to_device(self, host, number):
            start = time.perf_counter()
            out = to_device(self, host, number)
            probe.place.append(time.perf_counter() - start)
            return out

        def timed_step(self, *args, **kwargs):
            probe._step = {"events": None, "captured": 0.0}
            start = time.perf_counter()
            out = train_step(self, *args, **kwargs)
            probe._step["host_s"] = time.perf_counter() - start
            probe.steps.append(probe._step)
            probe._step = None
            return out

        def timed_graphed(self):
            if probe._step is None or not self._warm:
                return graphed(self)
            if self._graph is None:
                start = time.perf_counter()
                graphed(self)
                probe._step["captured"] = time.perf_counter() - start
                return
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record()
            graphed(self)
            after.record()
            probe._step["events"] = (before, after)

        def chosen(self, *args):
            placed = choose(self, *args)
            probe.placements.append(placed)
            return placed

        def fetching(**kwargs):
            probe.fetch_modes.append(kwargs["fetch_mode"])
            return loop(**kwargs)

        patches = ((pipeline.BatchPipeline, "__init__", timed_setup),
                   (pipeline.BatchPipeline, "_host_batch", timed_host_batch),
                   (pipeline.BatchPipeline, "_to_device", timed_to_device),
                   (step.TrainStep, "__call__", timed_step),
                   (step._GraphedBody, "__call__", timed_graphed),
                   (api.VariationalAutoencoder, "_choose_device_placement",
                    chosen),
                   (training, "run_training_loop", fetching))
        originals = [(owner, name, getattr(owner, name))
                     for owner, name, _ in patches]
        for owner, name, value in patches:
            setattr(owner, name, value)
        try:
            yield self
        finally:
            for owner, name, value in originals:
                setattr(owner, name, value)

    def report(self, result) -> dict:
        """Over all batches of the run: the host's ms per batch to build
        and to place it, and the seconds to set up a pipeline (its checks
        of the arrays: the count dtype, the wire's statistics).  Over the
        last epoch's steps: the replays' median device ms and host ms in
        the step's call, the captures and their seconds, and the device's
        busy share (the replays' device time over the epoch's wall time; a
        capture's step and the copies into the graphs' inputs are left
        out)."""
        torch.cuda.synchronize()
        last = self.steps[-result.steps_per_epoch:]
        replays = [s for s in last if s["events"] is not None]
        device_ms = [a.elapsed_time(b) for a, b in
                     (s["events"] for s in replays)]
        return {
            "host_ms": 1e3 * float(np.mean(self.host)),
            "place_ms": 1e3 * float(np.mean(self.place)),
            "replay_ms": float(np.median(device_ms)),
            "dispatch_ms": 1e3 * float(np.median([s["host_s"]
                                                  for s in replays])),
            "replays": len(replays),
            "captures": sum(bool(s["captured"]) for s in last),
            "capture_s": sum(s["captured"] for s in last),
            "setup_s": float(np.mean(self.setup)),
            "busy": sum(device_ms) / (1e3 * result.epoch_seconds[-1]),
        }


def stream_launch_check(label, launches, steps, fused=True, evaluated=0):
    """NB's K2 and K3's three kernels once per training step on a fused
    configuration, NB's float32 K2 once per ``evaluated`` evaluation batch,
    and no likelihood kernel otherwise; K1 never."""
    nb = {f"nb_{kernel}" for kernel in ("forward", "backward_gradient",
                                        "backward_dh", "backward_dw")}
    for kernel, count in launches.items():
        want = ((steps if fused and kernel in nb else 0)
                + (evaluated if kernel == "nb_forward_float32" else 0))
        if count != want:
            raise AssertionError(f"{label}: {kernel} launched {count} times "
                                 f"in {steps} streamed steps and {evaluated} "
                                 f"evaluation batches (want {want})")


def check_streamed_batches(counts, card):
    """Phase 4e (1): the headline counts through ``BatchPipeline`` with
    ``wire_format="auto"`` (which must pick the CSR wire), epoch 0 of seed
    0: each of the first three batches materialized on the card equal, bit
    for bit, to K1's gather of the same rows from the device-staged int16
    counts as float32; one training loss of the headline VAE-NB and its
    gradients on that batch from the same generator state on both routes
    (the device route as the epoch gathers it: bf16 fields and the staged
    row constants) within STREAM_LOSS_RTOL and STREAM_GRADIENT_RTOL of the
    largest |gradient|.  Prints the wire's capacity and bytes per batch
    against dense int16, and the overflow batches of an epoch."""
    from scvae_tpu_torch import DataSet, ops
    from scvae_tpu_torch.data.pipeline import (
        BatchPipeline,
        CSRWire,
        build_model_arrays,
        device_resident_data,
    )
    from scvae_tpu_torch.models import api, step, vae

    dev = torch.device("cuda")
    arrays = build_model_arrays(DataSet("in-memory", values=counts))
    stream = BatchPipeline(arrays, BATCH, seed=0,
                           count_dtype=api.VariationalAutoencoder
                           .DEVICE_COUNT_DTYPES, device=dev)
    if "x" not in stream._csr_wire:
        raise AssertionError("the headline counts did not take the CSR wire")
    spec = stream._csr_wire["x"]
    capacity = spec["capacity"]
    order = np.random.RandomState(0).permutation(N_CELLS)
    stored = np.diff(counts.indptr)
    overflows = sum(int(stored[order[i:i + BATCH]].sum()) > capacity
                    for i in range(0, N_CELLS, BATCH))
    wire_bytes = capacity * sum(np.dtype(d).itemsize for d in (
        np.int16, spec["col_dtype"], spec["row_dtype"]))
    config = vae.VAEConfig(feature_size=N_GENES, latent_size=LATENT,
                           hidden_sizes=(HIDDEN, HIDDEN),
                           reconstruction_distribution="negative binomial")
    data = api._append_lgamma_rowsum(device_resident_data(arrays, device=dev),
                                     config)
    dtypes = api._bf16_batch_dtypes(arrays, config, dev)
    params, state = vae.init(config, torch.Generator().manual_seed(0))
    exact = True
    for i, batch in zip(range(STREAM_CHECKED_BATCHES), stream.epoch()):
        if not isinstance(batch["x"], CSRWire) or batch["x"] is not (
                batch["t"]):
            raise AssertionError(f"streamed batch {i} is not one CSR wire")
        idx = torch.from_numpy(order[i * BATCH:(i + 1) * BATCH].astype(
            np.int32)).to(dev)
        streamed = step.cast_batch_to_f32(step.materialize_batch(batch))
        gathered = ops.gather_rows(data["x"], idx, torch.float32)
        if not torch.equal(streamed["x"], gathered):
            raise AssertionError(f"streamed batch {i} differs from K1's")
        device_batch = step.gather_batch(data, idx, dtype_overrides=dtypes)
        results = []
        for route in (device_batch, streamed):
            p = step.tree_map(lambda a: a.to(dev).requires_grad_(True),
                              params)
            s = step.tree_map(lambda a: a.to(dev), state)
            generator = torch.Generator(device=dev).manual_seed(i)
            loss, _ = vae.loss_fn(config, p, s, route, generator)
            grads = torch.autograd.grad(loss, step.tree_leaves(p))
            results.append((loss.detach(), torch.cat(
                [g.reshape(-1) for g in grads])))
        (loss_d, grads_d), (loss_s, grads_s) = results
        check_close(f"streamed batch {i} loss against the device route's",
                    loss_s, loss_d, STREAM_LOSS_RTOL)
        check_close(f"streamed batch {i} gradients against the device "
                    "route's", grads_s, grads_d, STREAM_GRADIENT_RTOL)
        exact = exact and torch.equal(grads_s, grads_d) and torch.equal(
            loss_s, loss_d)
    copies = {}
    for what, nbytes in (("wire", wire_bytes),
                         ("dense int16", BATCH * N_GENES * 2)):
        pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        target = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        copies[what] = time_ms(lambda: target.copy_(pinned,
                                                    non_blocking=True))
    print(f"stream batches: CSR wire capacity {capacity} entries, "
          f"{wire_bytes} bytes a batch against {BATCH * N_GENES * 2} dense "
          f"int16 ({BATCH * N_GENES * 2 / wire_bytes:.3g}x fewer); a copy "
          f"from pinned memory {copies['wire']:.4g} ms against "
          f"{copies['dense int16']:.4g} ms on the device; "
          f"{overflows} overflow batches of {-(-N_CELLS // BATCH)} in an "
          f"epoch; the first {STREAM_CHECKED_BATCHES} batches equal to K1's "
          "bit for bit, loss and gradients "
          f"{'bit for bit' if exact else 'within bounds'} on both routes "
          f"({card})", flush=True)


def stream_model(label, model_kind, name, **options):
    from scvae_tpu_torch import (
        GaussianMixtureVariationalAutoencoder,
        VariationalAutoencoder,
    )

    kwargs = dict(feature_size=options.pop("feature_size", N_GENES),
                  latent_size=LATENT, hidden_sizes=[HIDDEN, HIDDEN],
                  reconstruction_distribution=name,
                  log_directory=os.path.join(STREAM_DIRECTORY, label),
                  **options)
    if model_kind == "gmvae":
        return GaussianMixtureVariationalAutoencoder(
            number_of_latent_clusters=CLUSTERS, **kwargs)
    return VariationalAutoencoder(**kwargs)


def stream_run(label, model_kind, name, training_set, validation_set, card,
               fused=True, epochs=EPOCHS, rising=True, features=N_GENES,
               **train_options):
    """One streamed ``train`` through the API, probed; checks its launches
    (``stream_launch_check``), that it did not stage the set on the device,
    and a finite ELBO, rising from the first epoch to the last with
    ``rising``; returns (model, result, probe, launches)."""
    from scvae_tpu_torch import ops

    model = stream_model(label, model_kind, name, feature_size=features)
    probe = StreamProbe()
    ops.reset_launch_counts()
    with probe.watching():
        result = model.train(training_set, validation_set,
                             number_of_epochs=epochs, minibatch_size=BATCH,
                             seed=0, device="cuda", verbose=False,
                             **train_options)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    steps = result.steps_per_epoch * epochs
    # a fused VAE's per-epoch evaluations take NB's float32 K2
    evaluated = 0
    if fused and model_kind == "vae":
        evaluated = evaluation_batches(
            ([training_set] if train_options.get("full_train_evaluation",
                                                 True) else [])
            + ([validation_set] if validation_set is not None else []),
            epochs)
    stream_launch_check(label, launches, steps, fused, evaluated)
    if probe.placements and any(probe.placements):
        raise AssertionError(f"{label}: placed on the device")
    elbo = result.history["training"]["lower_bound"]
    if not (np.all(np.isfinite(elbo))
            and (not rising or epochs < 2 or elbo[-1] > elbo[0])):
        raise AssertionError(f"{label}: training ELBO {elbo}")
    report = probe.report(result)
    seconds = result.epoch_seconds[-1]
    report.update(steps_per_s=result.steps_per_epoch / seconds,
                  cells_per_s=set_rows(training_set) / seconds)
    print(f"stream {label}: ELBO {elbo}; epoch {epochs}: "
          f"{report['steps_per_s']:.6g} steps/s, "
          f"{report['cells_per_s']:.6g} cells/s, "
          f"{1e3 / report['steps_per_s']:.4g} ms a step; host "
          f"{report['host_ms']:.4g} ms a batch to densify or build the wire, "
          f"{report['place_ms']:.4g} ms to place it, "
          f"{report['dispatch_ms']:.4g} ms in a replayed step's call; a "
          f"replay {report['replay_ms']:.4g} ms on the device "
          f"({report['replays']} replays, {report['captures']} captures "
          f"taking {report['capture_s']:.4g} s in the epoch); a pipeline's "
          f"set-up {report['setup_s']:.4g} s; device busy "
          f"{report['busy']:.3g} of the epoch; "
          f"fetch {probe.fetch_modes}; launches "
          f"{({k: v for k, v in launches.items() if v})} ({card})",
          flush=True)
    return model, result, probe, launches


def phase_streaming(counts, card):
    """Phase 4e: the streaming path.  Returns the launches by the kernels
    line's entries (the GMVAE's NB kernels under the cycled ones, the
    over-budget run's under the nb_4096 ones)."""
    from scvae_tpu_torch import DataSet

    shutil.rmtree(STREAM_DIRECTORY, ignore_errors=True)
    check_streamed_batches(counts, card)
    total = collections.Counter()
    train, valid = split_counts(counts)

    # (2) the headline VAE-NB, streamed, deferred fetch asked for
    _, result, probe, launches = stream_run(
        "VAE-NB-stream", "vae", "negative binomial", train, valid, card,
        data_placement="streaming", metrics_fetch="deferred")
    if probe.fetch_modes != ["sync"]:
        raise AssertionError(f"VAE-NB-stream ran {probe.fetch_modes}")
    total.update(launches)
    print(f"stream VAE-NB: epoch {EPOCHS} streamed "
          f"{result.steps_per_epoch / result.epoch_seconds[-1]:.6g} steps/s "
          f"against {RATES['negative binomial']:.6g} on the device path "
          f"(phase 4) ({card})", flush=True)

    # (3) GMVAE-NB, 10 clusters: NB's kernels over 20,480 rows a step
    _, _, _, launches = stream_run(
        "GMVAE-NB-stream", "gmvae", "negative binomial", train, valid, card,
        data_placement="streaming")
    total.update({f"{k}_cycled": v for k, v in launches.items()})

    # (4) noisy preprocessing: "auto" must stream, each epoch new values
    from scvae_tpu_torch.models import api

    drawn = []

    class Recording(api.BatchPipeline):
        def __init__(self, arrays, *args, **kwargs):
            drawn.append(arrays["x"])
            super().__init__(arrays, *args, **kwargs)

    noisy = DataSet("in-memory", values=counts,
                    noisy_preprocessing_methods=["normalise", "binarise"])
    original, api.BatchPipeline = api.BatchPipeline, Recording
    try:
        np.random.seed(0)
        stream_run("VAE-Bernoulli-noisy", "vae", "bernoulli", noisy, None,
                   card, fused=False, rising=False, data_placement="auto")
    finally:
        api.BatchPipeline = original
    # epoch 1's training and evaluation arrays, then epoch 2's
    if len(drawn) != 2 * EPOCHS or (drawn[0] != drawn[2]).nnz == 0:
        raise AssertionError("the noisy epochs drew the same values")
    print(f"stream VAE-Bernoulli-noisy: {len(drawn)} noisy arrays drawn, "
          f"epochs 1 and 2 differ in {(drawn[0] != drawn[2]).nnz} of "
          f"{drawn[0].nnz} stored entries ({card})", flush=True)
    del drawn, noisy

    # (5) over the device budget
    free = host_free_bytes()
    start = time.perf_counter()
    over = over_budget_counts()
    build_s = time.perf_counter() - start
    dense_bytes = OVER_CELLS * OVER_GENES * 2
    print(f"stream over-budget set: {OVER_CELLS} x {OVER_GENES}, "
          f"{over.nnz} stored entries, built in {build_s:.3f} s; dense int16 "
          f"{dense_bytes / 1e9:.4g} GB against the budget "
          f"{api.VariationalAutoencoder.DEVICE_DATA_BUDGET_BYTES / 2**30:g} "
          f"GiB; host free {free / 2**30:.4g} GiB before, "
          f"{host_free_bytes() / 2**30:.4g} GiB after", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, result, probe, launches = stream_run(
        "VAE-NB-over-budget", "vae", "negative binomial", over, None, card,
        epochs=1, features=OVER_GENES, data_placement="auto",
        full_train_evaluation=False)
    peak = torch.cuda.max_memory_allocated()
    if probe.placements != [False]:
        raise AssertionError(f"over-budget placement {probe.placements}")
    if peak >= api.VariationalAutoencoder.DEVICE_DATA_BUDGET_BYTES:
        raise AssertionError(f"over-budget run peaked at {peak} bytes")
    total.update({f"{k.replace('nb_', 'nb_4096_')}": v
                  for k, v in launches.items()})
    evaluated = DataSet("in-memory", values=over[:OVER_EVALUATED])
    start = time.perf_counter()
    reconstructed = model.evaluate(evaluated, device="cuda", verbose=False,
                                   output_versions="reconstructed")
    evaluate_s = time.perf_counter() - start
    metrics = model._last_evaluation_metrics
    if not (reconstructed.values.shape == (OVER_EVALUATED, OVER_GENES)
            and np.all(np.isfinite(reconstructed.values))
            and all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"over-budget evaluation {metrics}, "
                             f"{reconstructed.values.shape}")
    print(f"stream VAE-NB-over-budget: peak device memory "
          f"{peak / 2**30:.4g} GiB (budget "
          f"{api.VariationalAutoencoder.DEVICE_DATA_BUDGET_BYTES / 2**30:g} "
          f"GiB); evaluate of {OVER_EVALUATED} rows in {evaluate_s:.3f} s: "
          f"{metrics}, p_x_mean {reconstructed.values.shape} ({card})",
          flush=True)
    return total


MESH_DIRECTORY = os.path.join(BUILD, "mesh_training")
MESH_CURVE_RTOL = 1e-6
# NCCL's kernels of an all-reduce: one rank's reduction, several ranks'
NCCL_REDUCTIONS = ("oneRankReduce", "AllReduce")
# (label, model, data placement, epochs)
MESHED = (("VAE-NB", "vae", "device", EPOCHS),
          ("GMVAE-NB", "gmvae", "device", EPOCHS),
          ("VAE-NB-stream", "vae", "streaming", 1))


def mesh_model(label, kind, run):
    from scvae_tpu_torch import (
        GaussianMixtureVariationalAutoencoder,
        VariationalAutoencoder,
    )

    kwargs = dict(feature_size=N_GENES, latent_size=LATENT,
                  hidden_sizes=[HIDDEN, HIDDEN],
                  reconstruction_distribution="negative binomial",
                  log_directory=os.path.join(MESH_DIRECTORY, label, run))
    if kind == "gmvae":
        return GaussianMixtureVariationalAutoencoder(
            number_of_latent_clusters=CLUSTERS, **kwargs)
    return VariationalAutoencoder(**kwargs)


def collectives_per_step(kind) -> int:
    """The all-reduces of one data-parallel training step: each batch norm
    (two a network; the VAE's encoder and decoder, the GMVAE's q(y|x),
    q(z|x, y) and decoder) averages its mean and its variance, and the
    backward each again; then one average of the gradients and the
    metrics."""
    layers = 2 * (3 if kind == "gmvae" else 2)
    return 4 * layers + 1


def mesh_run(label, kind, placement, epochs, training_set, validation_set,
             run, traced=False):
    """One ``train`` of a MESHED configuration, on the mesh unless ``run``
    is "single"; with ``traced``, for at least two epochs, with ``trace``
    around the last (its training and its evaluation passes: graph
    replays, and none of ``train``'s barriers).  Returns (result, launches
    of the run, the traced window's launches and collectives, trace
    directory)."""
    from scvae_tpu_torch import ops, parallel
    from scvae_tpu_torch.utils.profiling import trace

    traces = os.path.join(MESH_DIRECTORY, label, "trace")
    tracing = contextlib.ExitStack()
    window = {}

    def counts():
        return {**ops.launch_counts(), **parallel.collective_counts()}

    if traced:
        epochs = max(epochs, 2)

    def callback(epoch, train_state, metrics):
        if traced and epoch == epochs - 2:
            window["before"] = counts()
            tracing.enter_context(trace(traces))
        if traced and epoch == epochs - 1:
            torch.cuda.synchronize()
            tracing.close()
            window["after"] = counts()

    model = mesh_model(label, kind, run)
    ops.reset_launch_counts()
    parallel.reset_collective_counts()
    with tracing:
        result = model.train(
            training_set, validation_set, number_of_epochs=epochs,
            minibatch_size=BATCH, seed=0, device="cuda", verbose=False,
            data_placement=placement, epoch_callback=callback,
            number_of_devices=None if run == "single" else 1)
    torch.cuda.synchronize()
    traced_counts = ({name: window["after"][name] - window["before"].get(
        name, 0) for name in window["after"]} if traced else None)
    return result, ops.launch_counts(), traced_counts, traces


def mesh_evaluate(label, kind, evaluation_set):
    """``evaluate`` of the run without a mesh's checkpoint on
    ``evaluation_set``, without and with a mesh (``number_of_devices=1``):
    (the largest relative difference of the metrics, the same of each
    output array (its largest difference over its largest magnitude),
    the collectives of each kind counted in the mesh's evaluation, seconds
    of each)."""
    from scvae_tpu_torch import parallel

    runs, seconds = [], []
    for devices in (None, 1):
        model = mesh_model(label, kind, "single")
        parallel.reset_collective_counts()
        start = time.perf_counter()
        _, reconstructed, latent = model.evaluate(
            evaluation_set, device="cuda", verbose=False,
            number_of_devices=devices)
        seconds.append(time.perf_counter() - start)
        latents = latent if isinstance(latent, dict) else {"z": latent}
        arrays = {"reconstructed": reconstructed.values,
                  "stddev": reconstructed.total_standard_deviations.toarray()}
        arrays.update({f"latent {name}": np.asarray(value.values)
                       for name, value in latents.items()})
        runs.append((model._last_evaluation_metrics, arrays))
    (metrics, arrays), (metrics_m, arrays_m) = runs
    worst = max(abs(metrics_m[k] - v) / max(abs(v), 1e-30)
                for k, v in metrics.items())
    outputs = {name: float(np.max(np.abs(arrays_m[name] - want))
                           / max(float(np.max(np.abs(want))), 1e-30))
               for name, want in arrays.items()}
    return (worst, outputs, parallel.collective_counts(), seconds)


def phase_mesh(counts, card):
    """Phase 4f: data parallel on a world of one NCCL rank (a ``FileStore``
    under ``build/``, the group destroyed when the phase ends).  Each
    MESHED configuration trains at the headline width through
    ``train(number_of_devices=1)`` and beside it without a mesh; the phase
    holds the lower bounds within 1e-6 relative (on one rank the mesh
    changes no value), the same launches, NB's K2 and K3's three kernels
    once a step and K1 once a step and evaluation batch on the device
    path; in a second mesh run (two epochs) ``trace`` around epoch 2 finds
    NCCL's reduction kernels as often as the collectives were counted in
    it, the training steps' share of them ``collectives_per_step`` a step,
    and one for each evaluation (epoch on the device path, batch
    streamed); on the device path ``evaluate(number_of_devices=1)`` of
    the validation rows within 1e-6 relative of ``evaluate`` without the
    mesh (``mesh_evaluate``); prints
    the steps/s with and without the mesh.  Returns the mesh runs'
    launches by the kernels line's entries (the GMVAE's NB kernels under
    the cycled ones)."""
    import torch.distributed as dist

    from scvae_tpu_torch import parallel
    from scvae_tpu_torch.utils.profiling import summarize_trace

    start = time.perf_counter()
    shutil.rmtree(MESH_DIRECTORY, ignore_errors=True)
    os.makedirs(MESH_DIRECTORY)
    total = collections.Counter()
    train, valid = split_counts(counts)
    parallel.distributed_initialize(
        device="cuda",
        store=dist.FileStore(os.path.join(MESH_DIRECTORY, "store"), 1),
        world_size=1, rank=0)
    try:
        for label, kind, placement, epochs in MESHED:
            sets = ((counts, None) if placement == "device"
                    else (train, valid))
            single, single_launches, _, _ = mesh_run(
                label, kind, placement, epochs, *sets, "single")
            meshed, launches, _, _ = mesh_run(
                label, kind, placement, epochs, *sets, "mesh")
            _, _, window, traces = mesh_run(
                label, kind, placement, epochs, *sets, "traced", traced=True)
            worst = 0.0
            for subset, curves in single.history.items():
                for name, want in curves.items():
                    got = np.asarray(meshed.history[subset][name])
                    want = np.asarray(want)
                    worst = max(worst, float(np.max(
                        np.abs(got - want) / np.abs(want))))
            if not worst <= MESH_CURVE_RTOL:
                raise AssertionError(f"mesh {label}: curves {worst:.3g} "
                                     "relative from the run without a mesh")
            if launches != single_launches:
                raise AssertionError(f"mesh {label}: launches {launches}, "
                                     f"without the mesh {single_launches}")
            steps = meshed.steps_per_epoch
            for kernel in ("forward", "backward_gradient", "backward_dh",
                           "backward_dw"):
                if launches[f"nb_{kernel}"] != steps * epochs:
                    raise AssertionError(
                        f"mesh {label}: nb_{kernel} launched "
                        f"{launches[f'nb_{kernel}']} times in "
                        f"{steps * epochs} steps")
            # the device path's evaluation epoch averages once
            evaluations = 1
            if placement == "device":
                gathers = steps + counts.shape[0] // BATCH
                if window["gather_rows"] != gathers:
                    raise AssertionError(
                        f"mesh {label}: K1 {window['gather_rows']} times in "
                        f"epoch 2's {steps} steps and "
                        f"{counts.shape[0] // BATCH} evaluation batches")
            else:  # each evaluation batch's metrics averaged once
                evaluations = sum(-(-s.shape[0] // BATCH) for s in sets)
            per_step = collectives_per_step(kind)
            want = steps * per_step + evaluations
            entries = summarize_trace(traces, top=None)
            found = {entry["name"]: entry for entry in entries
                     if any(part in entry["name"]
                            for part in NCCL_REDUCTIONS)}
            reductions = sum(entry["count"] for entry in found.values())
            kinds = {kind: window[kind] for kind in
                     ("all_reduce", "all_reduce_sum", "all_gather")}
            if kinds["all_reduce_sum"]:
                raise AssertionError(f"mesh {label}: a model-axis all-reduce "
                                     f"without a model axis: {kinds}")
            if not window["all_reduce"] == want == reductions:
                raise AssertionError(
                    f"mesh {label}: {window['all_reduce']} all-reduces "
                    f"counted and {reductions} NCCL reduction kernels traced "
                    f"in epoch 2, {steps} steps x {per_step} + "
                    f"{evaluations} expected")
            if placement == "device":
                worst_metric, outputs, reduced, seconds = mesh_evaluate(
                    label, kind, valid)
                if not max([worst_metric, *outputs.values()]) <= (
                        MESH_CURVE_RTOL):
                    raise AssertionError(
                        f"mesh {label}: evaluate with the mesh "
                        f"{worst_metric:.3g} (metrics), {outputs} relative "
                        "from evaluate without it")
                print(f"mesh {label}: evaluate of {valid.shape[0]} rows with "
                      f"the mesh {worst_metric:.3g} (metrics), {outputs} "
                      f"relative from without it; collectives {reduced}; "
                      f"{seconds[1]:.3f} s with the mesh, {seconds[0]:.3f} s "
                      f"without ({card})", flush=True)
            rates = {run: result.steps_per_epoch / result.epoch_seconds[-1]
                     for run, result in (("mesh", meshed),
                                         ("single", single))}
            print(f"mesh {label}: {epochs} epoch(s) of {steps} steps on a "
                  f"world of one NCCL rank; lower bounds "
                  f"{meshed.history['training']['lower_bound']} (without "
                  f"the mesh {single.history['training']['lower_bound']}, "
                  f"{worst:.3g} relative at most); {per_step} all-reduces a "
                  f"step; epoch 2 traced: {reductions} NCCL reduction "
                  f"kernels ({ {n: e['count'] for n, e in found.items()} }, "
                  f"{sum(e['total_ms'] for e in found.values()):.4f} ms) = "
                  f"{window['all_reduce']} counted = {steps} x {per_step} + "
                  f"{evaluations}; collectives of each kind {kinds}; steps/s "
                  f"{rates['mesh']:.6g} with the "
                  f"mesh, {rates['single']:.6g} without ({card})",
                  flush=True)
            for name, count in launches.items():
                if count:
                    cycled = kind == "gmvae" and name != "gather_rows"
                    total[f"{name}_cycled" if cycled else name] += count
    finally:
        dist.destroy_process_group()
    print(f"mesh: phase {time.perf_counter() - start:.1f} s ({card})",
          flush=True)
    return total


def _grouped_batch(name, config, state, x, t):
    """One validation minibatch through the grouped kernels and through the
    flat kernels, with bf16 operands and in float32: log p(x|z,y) of the
    restored GMVAE's decoder states (K·S groups) against the batch's
    targets, and its gradients for the decoder states and the heads with
    the rows weighted by q(y|x) / (S·B), as the ELBO weights them.  Fails
    unless each grouped run launched K4 and each of K5's three kernels (the
    grouped gradient kernel, the dh and dW products) of its dtype exactly
    once and no other likelihood kernel, and unless it agrees with the flat
    run of its dtype.  Returns the grouped runs' launches."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.models import gmvae

    z_draws = torch.Generator(device=x.device).manual_seed(0)
    with torch.no_grad():
        outputs = gmvae.forward(config, state.params, state.model_state,
                                {"x": x, "t": x}, z_draws, training=False,
                                build_reconstruction=False)
    dec_h = outputs.decoder_hidden  # (K, S, B, H)
    n_clusters, n_samples, b = dec_h.shape[:3]
    weights = (outputs.q_y.probs.T[:, None, :] / (n_samples * b)).detach()
    prefix = ops.FAMILIES[name].prefix
    launched = {}
    for cdt, sfx, rtol in ((torch.bfloat16, "", BACKWARD_RTOL),
                           (None, "_float32", AUTOGRAD_RTOL)):
        results = []
        for grouped in (True, False):
            h = dec_h.detach().clone().requires_grad_(True)
            heads = {p: {k: v.detach().clone().requires_grad_(True)
                         for k, v in head.items()}
                     for p, head in state.params["reconstruction"].items()}
            leaves = [h] + [heads[p][k] for p in ops.FAMILIES[name].heads
                            for k in ("kernel", "bias")]
            ops.reset_launch_counts()
            if grouped:
                ll = ops.fused_grouped_log_likelihood(name, h, heads, t,
                                                      compute_dtype=cdt)
            else:
                ll = ops.fused_log_likelihood(name, h, heads, t,
                                              compute_dtype=cdt)
            grads = torch.autograd.grad((weights * ll).sum(), leaves)
            torch.cuda.synchronize()
            results.append((ll.detach(), grads, ops.launch_counts()))
        (ll, grads, launches), (ll_flat, grads_flat, _) = results
        want = {f"{prefix}_grouped_{kernel}{sfx}": 1
                for kernel in ("forward", "backward_gradient", "backward_dh",
                               "backward_dw")}
        launches = {k: v for k, v in launches.items() if v}
        if launches != want:
            raise AssertionError(f"grouped path{sfx} launched {launches}")
        tag = (f"{prefix} grouped{sfx} vs flat, {n_clusters}x{n_samples}x{b} "
               "rows")
        check_close(f"{tag} log p(x|z,y)", ll, ll_flat, FORWARD_RTOL)
        for i, (a, b_) in enumerate(zip(grads, grads_flat)):
            check_close(f"{tag} gradient [{i}]", a, b_, rtol)
        launched.update(launches)
    return launched


def after_training(label, model_kind, name, train, valid, card):
    """One configuration's life after training (phase 5); returns the
    grouped kernels' launches on its validation minibatches."""
    from scvae_tpu_torch import (
        GaussianMixtureVariationalAutoencoder,
        VariationalAutoencoder,
        ops,
        params,
    )
    from scvae_tpu_torch.models import checkpoints

    kwargs = dict(feature_size=N_GENES, latent_size=LATENT,
                  hidden_sizes=[HIDDEN, HIDDEN],
                  reconstruction_distribution=name,
                  log_directory=os.path.join(AFTER_DIRECTORY, label))
    if model_kind == "gmvae":
        model = GaussianMixtureVariationalAutoencoder(
            number_of_latent_clusters=CLUSTERS, **kwargs)
    else:
        model = VariationalAutoencoder(**kwargs)
    snapshots = []

    def keep(epoch, train_state, epoch_metrics):
        snapshots.append({
            part: {key: leaf.detach().cpu().clone()
                   for key, leaf in params.flatten(tree).items()}
            for part, tree in (("params", train_state.params),
                               ("model_state", train_state.model_state))})

    ops.reset_launch_counts()
    result = model.train(train, valid, number_of_epochs=AFTER_EPOCHS,
                         minibatch_size=BATCH, seed=0, device="cuda",
                         verbose=False, epoch_callback=keep)
    torch.cuda.synchronize()
    if any(v for k, v in ops.launch_counts().items() if "_grouped_" in k):
        raise AssertionError(f"{label}: training launched a grouped kernel")
    curves = result.history
    directory = model.log_directory()
    best = model.log_directory(best_model=True)
    for path in (os.path.join(directory, checkpoints.CHECKPOINT_FILE),
                 os.path.join(directory, checkpoints.METADATA_FILE),
                 os.path.join(directory, checkpoints.LEARNING_CURVES_FILE),
                 os.path.join(best, checkpoints.CHECKPOINT_FILE)):
        if not os.path.exists(path):
            raise AssertionError(f"{label}: {path} is missing")
    if len(curves["validation"]["lower_bound"]) != AFTER_EPOCHS:
        raise AssertionError(f"{label}: validation curve {curves}")
    if model_kind == "gmvae":
        centroids = checkpoints.load_centroids(directory)
        if centroids["means"].shape[0] != AFTER_EPOCHS:
            raise AssertionError(f"{label}: centroids of "
                                 f"{centroids['means'].shape[0]} epochs")
    restored, metadata = checkpoints.restore_checkpoint(best,
                                                        result.train_state)
    kept = snapshots[result.best_epoch]
    for part, tree in (("params", restored.params),
                       ("model_state", restored.model_state)):
        for key, leaf in params.flatten(tree).items():
            if not torch.equal(leaf.cpu(), kept[part][key]):
                raise AssertionError(f"{label}: best/ {part}{key} differs "
                                     f"from epoch {result.best_epoch + 1}")
    if metadata["epoch"] != result.best_epoch + 1:
        raise AssertionError(f"{label}: best/ holds epoch {metadata['epoch']}")

    ops.reset_launch_counts()
    start = time.perf_counter()
    _, reconstructed, _ = model.evaluate(valid, use_best_model=True,
                                         device="cuda", verbose=False)
    evaluate_s = time.perf_counter() - start
    metrics = model._last_evaluation_metrics
    values = reconstructed.values
    if ops.launch_counts()["gather_rows"]:
        raise AssertionError(f"{label}: evaluate gathered with K1; it reads "
                             "its set through the pipeline")
    if not (all(np.isfinite(v) for v in metrics.values())
            and values.shape == valid.shape and np.all(np.isfinite(values))
            and np.all(values >= 0)):
        raise AssertionError(f"{label}: evaluation {metrics}, "
                             f"reconstruction {values.shape}")
    samples = model.sample(SAMPLES, use_best_model=True, device="cuda").values
    if not (samples.shape == (SAMPLES, N_GENES) and np.all(np.isfinite(samples))
            and np.all(samples >= 0)):
        raise AssertionError(f"{label}: samples {samples.shape}")

    launches = {}
    if model_kind == "gmvae":
        dev = torch.device("cuda")
        valid_dev = torch.from_numpy(valid.toarray().astype(np.int16)).to(dev)
        for start_row in range(0, valid.shape[0], BATCH):
            idx = torch.arange(start_row, min(start_row + BATCH,
                                              valid.shape[0]),
                               dtype=torch.int32, device=dev)
            x = ops.gather_rows(valid_dev, idx, torch.float32)
            t = ops.gather_rows(valid_dev, idx, torch.bfloat16)
            for kernel, count in _grouped_batch(name, model.config, restored,
                                                x, t).items():
                launches[kernel] = launches.get(kernel, 0) + count
    print(f"after {label}: ELBO(valid) {curves['validation']['lower_bound']},"
          f" best epoch {result.best_epoch + 1}; evaluation {metrics} in "
          f"{evaluate_s:.3f} s; {SAMPLES} samples, mean "
          f"{float(samples.mean()):.6g}; grouped launches {launches} "
          f"({card})", flush=True)
    return launches


def phase_after(counts, card):
    """Phase 5 for VAE-NB and a GMVAE of each base family."""
    shutil.rmtree(AFTER_DIRECTORY, ignore_errors=True)
    train, valid = split_counts(counts)
    launches = {}
    runs = [("VAE-NB", "vae", "negative binomial")] + [
        (f"GMVAE-{name}", "gmvae", name) for name in BASE_FAMILIES]
    for label, model_kind, name in runs:
        for kernel, count in after_training(label, model_kind, name, train,
                                            valid, card).items():
            launches[kernel] = launches.get(kernel, 0) + count
    return launches


# Phase 5b: the development set (the golden runs of tests/test_golden.py)
# and the headline width with labels.
DATA_DIRECTORY = os.path.join(BUILD, "data")
DATA_RUNS_DIRECTORY = os.path.join(BUILD, "data_training")
DEVELOPMENT_FILTER = ["random", 1000]
DEVELOPMENT_MINIBATCH = 100
DEVELOPMENT_HIDDEN = 32
GOLDEN_CLUSTERS = 3
GOLDEN = (
    ("VAE-NB", "vae", dict(number_of_warm_up_epochs=5), 10),
    ("GMVAE-NB", "gmvae", dict(number_of_latent_clusters=GOLDEN_CLUSTERS),
     3),
)
LABELLED_CLASSES = 10
LABELLED_EPOCHS = 3


def development_split():
    """Phase 5b (a)'s set: the development set, 1,000 rows kept at random
    (the reference's seed 90) and split 0.9 at random (seed 42), built in
    memory from ``create_development_data_set()`` with the same filter as
    ``DataSet("development", example_filter=...)`` applies (whose HDF5
    cache needs ``h5py``, which the card's machine lacks)."""
    import scipy.sparse

    from scvae_tpu_torch.data import DataSet, create_development_data_set
    from scvae_tpu_torch.data import processing
    from scvae_tpu_torch.data.parsing import DATA_SET_CATALOGUE
    from scvae_tpu_torch.data.sparse import SparseRowMatrix

    raw = create_development_data_set()
    values, names, labels, _ = processing.filter_examples(
        {"original": raw["values"]}, raw["example names"],
        DEVELOPMENT_FILTER[0], DEVELOPMENT_FILTER[1:], labels=raw["labels"])
    data_set = DataSet(
        "development", specifications=DATA_SET_CATALOGUE["development"],
        values=SparseRowMatrix(scipy.sparse.csr_matrix(values["original"])),
        labels=labels, example_names=names,
        feature_names=raw["feature names"],
        example_filter=DEVELOPMENT_FILTER)
    return data_set.split(method="random", fraction=0.9)


def check_development_split(splits):
    """The split's values, labels and names against the reference's seeds
    applied here by hand, and each set's staged device copy against its
    host values, bit for bit."""
    from scvae_tpu_torch.data import create_development_data_set
    from scvae_tpu_torch.data.pipeline import (
        build_model_arrays,
        device_resident_data,
    )

    raw = create_development_data_set()
    kept = np.random.RandomState(90).permutation(raw["values"].shape[0])[
        :DEVELOPMENT_FILTER[1]]
    order = kept[np.random.RandomState(42).permutation(kept.size)]
    n_training_validation = int(0.9 * kept.size)
    n_training = int(0.9 * n_training_validation)
    rows = (order[:n_training], order[n_training:n_training_validation],
            order[n_training_validation:])
    for data_set, want in zip(splits, rows):
        staged = device_resident_data(build_model_arrays(data_set),
                                      device="cuda")["x"].cpu().numpy()
        if not (np.array_equal(data_set.values.toarray(),
                               raw["values"][want])
                and np.array_equal(data_set.labels, raw["labels"][want])
                and np.array_equal(data_set.example_names,
                                   raw["example names"][want])
                and np.array_equal(staged, data_set.values.toarray())):
            raise AssertionError(f"development {data_set.kind} set differs "
                                 "from the reference's rows")


def check_development_kernels(training_set, config):
    """K1 and NB's K2 and K3 at the golden runs' shapes, against their plain
    versions at phase 3's tolerances: K1 gathers a minibatch of 100 rows of
    the staged development counts (F = 25, under one 64-gene tile, on its
    element path) to the dtype training gathers them to; K2 and K3 take
    decoder rows of width 32 against those targets, bf16 inputs and the
    staged lgamma constant, 100 rows for the VAE and 300 cycled rows for
    the GMVAE with 3 clusters."""
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.data.pipeline import (
        build_model_arrays,
        device_resident_data,
    )
    from scvae_tpu_torch.models.api import _bf16_batch_dtypes

    gen = torch.Generator(device="cuda").manual_seed(5)
    arrays = build_model_arrays(training_set)
    staged = device_resident_data(arrays, device="cuda")["x"]
    dtype = (_bf16_batch_dtypes(arrays, config, torch.device("cuda"))
             or {}).get("x", torch.float32)
    idx = torch.randperm(staged.shape[0], generator=gen, device="cuda")[
        :DEVELOPMENT_MINIBATCH].int()
    t = ops.gather_rows(staged, idx, dtype)
    if t.dtype != dtype or not torch.equal(
            t, ops.reference_gather(staged, idx, dtype)):
        raise AssertionError("gather_rows is not bit-exact on the "
                             "development set")
    log(f"check gather_rows development {tuple(t.shape)} "
        f"{staged.dtype} -> {dtype}: bit-exact")
    name, bf16 = "negative binomial", torch.bfloat16
    hidden, f = DEVELOPMENT_HIDDEN, t.shape[1]
    ws, bs = head_weights(gen, 2, hidden, f, t.device)
    for clusters in (1, GOLDEN_CLUSTERS):
        m = clusters * t.shape[0]
        h = torch.relu(torch.randn(m, hidden, generator=gen, device="cuda"))
        g = torch.randn(m, generator=gen, device="cuda") / t.shape[0]
        tag = f"development M={m} over {t.shape[0]} target rows"
        check_close(
            f"nb_forward {tag}",
            ops.fused_forward(name, h, ws, bs, t, compute_dtype=bf16,
                              include_lgamma_const=False),
            ops.reference_forward(name, h, ws, bs, t, compute_dtype=bf16,
                                  include_lgamma_const=False),
            FORWARD_RTOL)
        got = ops.fused_backward(name, g, h, ws, bs, t, compute_dtype=bf16)
        want = ops.reference_backward(name, g, h, ws, bs, t,
                                      compute_dtype=bf16)
        for i, (a, b) in enumerate(zip(got, want)):
            check_close(f"nb_backward [{i}] {tag}", a, b, BACKWARD_RTOL)


def majority_vote(labels, cluster_ids, excluded):
    """The cluster-to-label majority vote recomputed on the names, apart
    from the package's: each cluster takes its most frequent label among
    the rows whose label is not ``excluded``, the first name in sorted
    order on a tie (the smallest class id, as the package's vote gives it).
    Returns ({cluster: name}, the accuracy over those rows)."""
    keep = ~np.isin(labels, list(excluded))
    votes = collections.Counter(zip(cluster_ids[keep].tolist(),
                                    labels[keep].tolist()))
    best = {}
    for (cluster, label), count in sorted(votes.items()):
        if cluster not in best or count > best[cluster][1]:
            best[cluster] = (label, count)
    accuracy = sum(count for _, count in best.values()) / int(keep.sum())
    return {cluster: label for cluster, (label, _) in best.items()}, accuracy


def check_accuracy(label, data_set, result, device="cuda"):
    """The last epoch's validation accuracy against q(y|x)'s argmax from
    the trained parameters on the card, with the vote recomputed on the
    host (:func:`majority_vote`); returns the vote's mapping and accuracy."""
    from scvae_tpu_torch.models import gmvae

    x = torch.from_numpy(
        np.ascontiguousarray(data_set.values.toarray(), np.float32)).to(device)
    ids = gmvae.cluster_ids(result.train_state.params,
                            result.train_state.model_state, x).cpu().numpy()
    mapping, accuracy = majority_vote(data_set.labels, ids,
                                      data_set.excluded_classes or [])
    trained = result.history["validation"]["accuracy"][-1]
    if accuracy != trained:
        raise AssertionError(f"{label}: validation accuracy {accuracy} "
                             f"recomputed, {trained} in training")
    return mapping, accuracy


def check_step_launches(label, launches, steps):
    """NB's K2 and K3's three kernels once per training step, K1 at least
    once."""
    for kernel in ("forward", "backward_gradient", "backward_dh",
                   "backward_dw"):
        if launches[f"nb_{kernel}"] != steps:
            raise AssertionError(f"{label}: nb_{kernel} launched "
                                 f"{launches[f'nb_{kernel}']} times in "
                                 f"{steps} training steps")
    if launches["gather_rows"] < 1:
        raise AssertionError(f"{label}: K1 was not launched")


def phase_development(card):
    """Phase 5b (a): the development set, K1 and NB's K2/K3 at its shapes,
    then the golden configurations of tests/test_golden.py trained on the
    card on the port's own draws; returns the golden runs' launches by
    kernel entry (the GMVAE's NB kernels under their cycled entries)."""
    from scvae_tpu_torch import (
        GaussianMixtureVariationalAutoencoder,
        VariationalAutoencoder,
        ops,
    )

    start = time.perf_counter()
    splits = development_split()
    seconds = time.perf_counter() - start
    check_development_split(splits)
    training_set, validation_set, _ = splits
    print(f"data development: built in memory in {seconds:.3f} s; "
          f"{[s.number_of_examples for s in splits]} rows, values, labels "
          "and rows equal to the reference's seeds on the host and on the "
          "card", flush=True)
    launches = {}
    for label, kind, options, epochs in GOLDEN:
        model_class = (GaussianMixtureVariationalAutoencoder
                       if kind == "gmvae" else VariationalAutoencoder)
        model = model_class(
            feature_size=25, latent_size=2, hidden_sizes=[DEVELOPMENT_HIDDEN],
            reconstruction_distribution="negative binomial",
            log_directory=os.path.join(DATA_RUNS_DIRECTORY, label),
            **options)
        if kind == "vae":
            check_development_kernels(training_set, model.config)
        ops.reset_launch_counts()
        result = model.train(
            training_set, validation_set, number_of_epochs=epochs,
            minibatch_size=DEVELOPMENT_MINIBATCH, learning_rate=1e-3, seed=0,
            device="cuda", verbose=False)
        torch.cuda.synchronize()
        run = ops.launch_counts()
        check_step_launches(f"golden {label}", run,
                            result.steps_per_epoch * epochs)
        for kernel, count in run.items():
            entry = kernel + "_cycled" if kind == "gmvae" else kernel
            entry = kernel if kernel == "gather_rows" else entry
            launches[entry] = launches.get(entry, 0) + count
        history = result.history
        for set_kind in ("training", "validation"):
            curve = history[set_kind]["lower_bound"]
            if len(curve) != epochs or not np.all(np.isfinite(curve)):
                raise AssertionError(f"golden {label} {set_kind}: {curve}")
            accuracy = history[set_kind].get("accuracy")
            if kind == "gmvae" and not (
                    accuracy is not None and len(accuracy) == epochs
                    and all(0.0 <= a <= 1.0 for a in accuracy)):
                raise AssertionError(f"golden {label} {set_kind} accuracy "
                                     f"{accuracy}")
        recomputed = ""
        if kind == "gmvae":
            _, accuracy = check_accuracy(f"golden {label}", validation_set,
                                         result)
            recomputed = f" (recomputed {accuracy})"
        print(f"data golden {label}: ELBO(valid) "
              f"{history['validation']['lower_bound']}, KL(valid) "
              f"{history['validation']['kl_divergence']}"
              + (f", accuracy(valid) {history['validation']['accuracy']}"
                 f"{recomputed}" if kind == "gmvae" else "")
              + f"; launches {({k: v for k, v in run.items() if v})} "
              f"({card})", flush=True)
    return launches


def labelled_headline(counts):
    """Phase 5b (b)'s set: the headline counts with 10 class names drawn
    from ``RandomState(2)``, one of them excluded, split 0.9 at random."""
    from scvae_tpu_torch.data import DataSet
    from scvae_tpu_torch.data.sparse import SparseRowMatrix

    names = np.array([f"type {chr(ord('A') + i)}"
                      for i in range(LABELLED_CLASSES)])
    labels = names[np.random.RandomState(2).randint(0, LABELLED_CLASSES,
                                                    counts.shape[0])]
    data_set = DataSet(
        "headline", specifications={"excluded classes": [str(names[-1])]},
        values=SparseRowMatrix(counts), labels=labels,
        example_names=np.array([f"cell {i + 1}"
                                for i in range(counts.shape[0])]),
        feature_names=np.array([f"gene {j + 1}"
                                for j in range(counts.shape[1])]))
    return data_set.split(method="random", fraction=0.9)


def phase_labelled(counts, card):
    """Phase 5b (b): GMVAE-NB with 10 clusters at the headline width on
    the labelled split, three epochs with the validation set and the
    accuracy; returns the training's kernel launches."""
    from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder, ops

    training_set, validation_set, test_set = labelled_headline(counts)
    sizes = [s.number_of_examples for s in (training_set, validation_set,
                                            test_set)]
    if sizes != [55_548, 6_173, 6_858]:
        raise AssertionError(f"labelled split of {sizes} rows")
    model = GaussianMixtureVariationalAutoencoder(
        feature_size=N_GENES, latent_size=LATENT,
        hidden_sizes=[HIDDEN, HIDDEN],
        reconstruction_distribution="negative binomial",
        number_of_latent_clusters=CLUSTERS,
        log_directory=os.path.join(DATA_RUNS_DIRECTORY, "labelled"))
    callback_seconds = []
    make_callback = model._make_accuracy_callback

    def timed_accuracy_callback(*args):
        callback = make_callback(*args)

        def timed(*callback_args):
            torch.cuda.synchronize()
            start = time.perf_counter()
            callback(*callback_args)
            callback_seconds.append(time.perf_counter() - start)

        return timed

    model._make_accuracy_callback = timed_accuracy_callback
    ops.reset_launch_counts()
    result = model.train(training_set, validation_set,
                         number_of_epochs=LABELLED_EPOCHS,
                         minibatch_size=BATCH, seed=0, device="cuda",
                         verbose=False, track_accuracy=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_step_launches("labelled GMVAE",
                        launches, result.steps_per_epoch * LABELLED_EPOCHS)
    history = result.history
    for kind in ("training", "validation"):
        accuracy = history[kind]["accuracy"]
        if not (len(accuracy) == LABELLED_EPOCHS
                and all(np.isfinite(a) and 0.0 <= a <= 1.0
                        for a in accuracy)):
            raise AssertionError(f"labelled GMVAE {kind} accuracy {accuracy}")
    _, accuracy = check_accuracy("labelled GMVAE", validation_set, result)

    evaluated = model.evaluate(validation_set, device="cuda", verbose=False,
                               output_versions="transformed")
    # a cluster whose rows all carry an excluded label maps to class id 0
    ids = evaluated.predicted_cluster_ids
    evaluated_mapping, _ = majority_vote(validation_set.labels, ids,
                                         validation_set.excluded_classes)
    names = np.array([evaluated_mapping.get(i, validation_set.class_names[0])
                      for i in ids.tolist()])
    if not np.array_equal(evaluated.predicted_labels, names):
        raise AssertionError("evaluate's predicted labels differ from the "
                             "majority vote of its cluster ids")
    seconds = result.epoch_seconds[-1]
    print(f"data labelled GMVAE-NB: {sizes} rows; accuracy(train) "
          f"{history['training']['accuracy']}, accuracy(valid) "
          f"{history['validation']['accuracy']} (recomputed {accuracy}); "
          f"ELBO(valid) {history['validation']['lower_bound']}; "
          f"accuracy callback {[round(t, 4) for t in callback_seconds]} s "
          f"per epoch; epoch {LABELLED_EPOCHS}: "
          f"{result.steps_per_epoch / seconds:.6g} steps/s; launches "
          f"{({k: v for k, v in launches.items() if v})} ({card})",
          flush=True)
    return launches, (model, result, (training_set, validation_set, test_set))


ANALYSES_DIRECTORY = os.path.join(BUILD, "analyses")
ANALYSIS_SEED = 0
ANALYSIS_RTOL = 1e-6
AMI_ATOL = 1e-12
KMEANS_MINIMUM_ARI = 0.999


def timed(seconds, part, fn, *args, **kwargs):
    """``fn``'s result, its wall seconds (the device synchronised) kept
    under ``part``."""
    synchronise()
    start = time.perf_counter()
    value = fn(*args, **kwargs)
    synchronise()
    seconds[part] = time.perf_counter() - start
    return value


def check_equal(name, got, want, atol=0.0):
    log(f"check {name}: {got!r} against {want!r} on the CPU (limit {atol:g})")
    if not (got == want or abs(got - want) <= atol
            or (np.isnan(got) and np.isnan(want))):
        raise AssertionError(f"{name}: {got} on the card, {want} on the CPU")


def check_relative(name, got, want, rtol=ANALYSIS_RTOL):
    """Arrays, or dicts of numbers, within ``rtol`` of the largest |want|."""
    if isinstance(want, dict):
        keys = [k for k, v in want.items() if isinstance(v, float)]
        got = np.array([got[k] for k in keys])
        want = np.array([want[k] for k in keys])
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.nanmax(np.abs(want)))
    err = float(np.nanmax(np.abs(got - want)))
    log(f"check {name}: max abs error {err:.3g}, {err / scale:.3g} of "
        f"{scale:.4g} (limit {rtol:g})")
    if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                     np.isnan(want)):
        raise AssertionError(f"{name}: shapes or NaNs differ")
    if not err <= rtol * scale:
        raise AssertionError(f"{name}: {err} exceeds {rtol} x {scale}")


def check_status_methods(model, result):
    """The status methods against the training run: trained, a best model,
    the epochs of each version, the curves of the loop."""
    trained = model.number_of_epochs_trained()
    best = model.number_of_epochs_trained(best_model=True)
    log(f"check status methods: trained {model.has_been_trained()}, best "
        f"model {model.better_model_exists()} (epoch {best}), stopped early "
        f"{model.model_stopped_early()}, {trained} epochs")
    if not (model.has_been_trained() and model.better_model_exists()
            and trained == result.number_of_epochs_trained == LABELLED_EPOCHS
            and best == result.best_epoch + 1):
        raise AssertionError(f"status methods: {trained} epochs trained, "
                             f"best {best}; the run: "
                             f"{result.number_of_epochs_trained}, "
                             f"{result.best_epoch}")
    if model.model_stopped_early() and not (
            0 < model.number_of_epochs_trained(early_stopping=True) <= trained):
        raise AssertionError("status methods: the early-stopping version")
    if model.learning_curves() != result.history:
        raise AssertionError("learning_curves differs from the loop's curves")
    if model.has_been_trained(run_id="absent"):
        raise AssertionError("status methods: an absent run is trained")


def expected_result_files(directory, kind, specifications):
    names = [f"{kind}-metrics.log", f"{kind}-metrics.pkl.gz",
             f"{kind}-prediction-{specifications.name}.log",
             f"{kind}-prediction-{specifications.name}.pkl.gz",
             f"predictions_{kind}.tsv.gz", f"latent_values_{kind}.tsv.gz"]
    return [os.path.join(directory, name) for name in names]


def phase_analyses(model, result, sets, card, device="cuda"):
    """Phase 5c: the analyses of phase 5b (b)'s labelled GMVAE-NB on
    ``device``, each held against the same function on the CPU; returns
    each part's seconds on ``device`` and the (training, test) latent
    values."""
    import gzip
    import pickle

    from scvae_tpu_torch.analyses import (
        PredictionSpecifications,
        analyse_results,
        decompose,
        metrics,
        predict_labels,
    )
    from scvae_tpu_torch.analyses.kmeans import MiniBatchKMeans
    from scvae_tpu_torch.models import checkpoints

    training_set, _, test_set = sets
    seconds = {}
    timed(seconds, "status methods", check_status_methods, model, result)

    transformed, reconstructed, latent = timed(
        seconds, "evaluate (test)", model.evaluate, test_set,
        use_best_model=False, verbose=False, device=device)
    training_latent = timed(
        seconds, "evaluate (training, latent)", model.evaluate, training_set,
        output_versions="latent", verbose=False, device=device)["z"]
    test_latent = latent["z"]
    if test_latent.values.shape != (test_set.number_of_examples, LATENT):
        raise AssertionError(f"latent values {test_latent.values.shape}")

    # k-means on the training latents (mini-batch above 10,000 rows)
    specifications = PredictionSpecifications("k-means", CLUSTERS,
                                              "training")
    predictions = timed(seconds, "k-means predict_labels", predict_labels,
                        training_latent, test_latent,
                        specifications=specifications, seed=ANALYSIS_SEED,
                        device=device)
    cpu_predictions = predict_labels(training_latent, test_latent,
                                     specifications=specifications,
                                     seed=ANALYSIS_SEED, device="cpu")
    partition_ari = metrics.adjusted_rand_index(
        predictions[0], cpu_predictions[0], device="cpu")
    log(f"check k-means partition: ARI {partition_ari} against the CPU's "
        f"from the same seed (limit {KMEANS_MINIMUM_ARI})")
    if partition_ari < KMEANS_MINIMUM_ARI:
        raise AssertionError(f"k-means: ARI {partition_ari} against the CPU")
    card_kmeans = timed(seconds, "mini-batch k-means fit", MiniBatchKMeans(
        CLUSTERS, seed=ANALYSIS_SEED, device=device).fit,
        training_latent.values)
    cpu_kmeans = MiniBatchKMeans(CLUSTERS, seed=ANALYSIS_SEED,
                                 device="cpu").fit(training_latent.values)
    check_equal("mini-batch k-means steps", card_kmeans.n_steps_,
                cpu_kmeans.n_steps_)
    check_relative("mini-batch k-means inertia", card_kmeans.inertia_,
                   cpu_kmeans.inertia_)
    model_predictions = predict_labels(training_latent, test_latent,
                                       method="model",
                                       number_of_clusters=CLUSTERS,
                                       device=device)
    if not np.array_equal(model_predictions[1], test_latent.predicted_labels):
        raise AssertionError("the model's predicted labels")
    for data_set in (transformed, reconstructed):
        data_set.update_predictions(
            prediction_specifications=specifications,
            predicted_cluster_ids=predictions[0],
            predicted_labels=predictions[1],
            predicted_superset_labels=predictions[2])

    # clustering metrics over the 2,048-gene test values, then the
    # silhouette of the training latents at the 20,000-row sample
    clustering = timed(seconds, "clustering metrics (test values)",
                       metrics.compute_clustering_metrics, transformed,
                       device=device)
    cpu_clustering = metrics.compute_clustering_metrics(transformed,
                                                        device="cpu")
    for name, values in cpu_clustering.items():
        for key, value in values.items():
            if value is None:
                continue
            tolerance = AMI_ATOL if "mutual" in name else 0.0
            if name == "silhouette score":
                check_relative(f"{name} ({key})", clustering[name][key],
                               value)
            else:
                check_equal(f"{name} ({key})", clustering[name][key], value,
                            tolerance)
    sampled = timed(seconds, "silhouette (training latents, sampled)",
                    metrics.silhouette_score, training_latent.values,
                    card_kmeans.labels_, seed=ANALYSIS_SEED, device=device)
    check_relative("silhouette (training latents, 20,000 sampled)", sampled,
                   metrics.silhouette_score(training_latent.values,
                                            card_kmeans.labels_,
                                            seed=ANALYSIS_SEED, device="cpu"))

    for label, values in (("test values", test_set.values),
                          ("test latents", test_latent.values)):
        check_relative(f"summary statistics ({label})", timed(
            seconds, f"summary statistics ({label})",
            metrics.summary_statistics, values, tolerance=0.5,
            device=device), metrics.summary_statistics(
                values, tolerance=0.5, device="cpu"))

    centroids = checkpoints.load_centroids(model.log_directory())
    centroids = {"prior": {key: np.asarray(value[-1])
                           for key, value in centroids.items()}}
    got = timed(seconds, "PCA (training latents, centroids)", decompose,
                training_latent.values, centroids=centroids, method="PCA",
                number_of_components=2, device=device)
    want = decompose(training_latent.values, centroids=centroids,
                     method="PCA", number_of_components=2, device="cpu")
    check_relative("PCA of the training latents", got[0], want[0])
    for parameter, values in want[1]["prior"].items():
        check_relative(f"PCA of the centroids' {parameter}",
                       got[1]["prior"][parameter], values)
    check_relative("IncrementalPCA of the test values", timed(
        seconds, "IncrementalPCA (test values)", decompose, test_set.values,
        method="PCA", device=device), decompose(test_set.values,
                                                method="PCA", device="cpu"))

    shutil.rmtree(ANALYSES_DIRECTORY, ignore_errors=True)
    for included in (["metrics", "predictions"], ["latent_values"]):
        files = timed(seconds, f"analyse_results ({', '.join(included)})",
                      analyse_results, transformed, reconstructed, latent,
                      model, included_analyses=included,
                      analyses_directory=ANALYSES_DIRECTORY, device=device)
    for path in expected_result_files(files["directory"], test_set.kind,
                                      specifications):
        if not os.path.isfile(path):
            raise AssertionError(f"analyse_results wrote no {path}")
        if path.endswith(".pkl.gz"):
            with gzip.open(path) as f:
                pickle.load(f)
    print(f"analyses of the labelled GMVAE-NB: k-means accuracy "
          f"{clustering['accuracies']['accuracy']}, ARI (clusters) "
          f"{clustering['adjusted Rand index']['clusters']}, silhouette "
          f"(clusters) {clustering['silhouette score']['clusters']}, "
          f"(training latents, sampled) {sampled}; mini-batch k-means "
          f"{card_kmeans.n_steps_} steps; seconds "
          f"{ {k: round(v, 4) for k, v in seconds.items()} } ({card})",
          flush=True)
    return seconds, (training_latent.values, test_latent.values)


def phase_data(counts, card):
    """Phase 5b: the data engine on the card, then phase 5c, the analyses
    of (b)'s model; returns the launches of (a)'s and (b)'s training runs
    by kernel entry (the GMVAEs' NB kernels under their cycled entries)
    and 5c's (training, test) latent values."""
    shutil.rmtree(DATA_RUNS_DIRECTORY, ignore_errors=True)
    launches = phase_development(card)
    labelled, run = phase_labelled(counts, card)
    for kernel, count in labelled.items():
        entry = kernel if kernel == "gather_rows" else kernel + "_cycled"
        launches[entry] = launches.get(entry, 0) + count
    _, latents = phase_analyses(*run, card)
    return launches, latents


# Phase 5d: the intermediate analyses and the figure analyses' computing
# parts.  t-SNE's checks against the CPU run on a sample of the test
# latents (the CPU takes ~0.25 s a step at 6,858 rows): P, the start and
# the first gradient, then the whole descent's KL(P ‖ Q) and 10-nearest-
# neighbour preservation.
INTERMEDIATE_DIRECTORY = os.path.join(BUILD, "intermediate_training")
INTERMEDIATE_ROWS = 2_000
TSNE_SAMPLE = 2_000
# ICA's fixed point on these near-Gaussian latents (singular values 81.0,
# 76.5, 74.2, …) does not converge in 200 steps, and a rounding difference
# grows until the 200th step's rotation parts (card against CPU O(1); JAX
# against the port on the CPU 2%): the steps are held to the 20th (read
# 6e-11), the whole run timed on the card alone.
ICA_CHECKED_STEPS = 20
# The first gradient: float32 sums over every pair in another order, and
# the repulsion's y_i Σq² − Σq² y_j in float32.
TSNE_GRADIENT_RTOL = 1e-4
# The sample's P and gradient on the card once more with chunks of 65
# rows for the neighbours (2,000 float64 distances a row) and 131 for the
# repulsion (2,000 float32 kernel values a row), against the CPU's one
# chunk: the chunk offsets and the normaliser summed over chunks.
TSNE_SMALL_CHUNK_BYTES = 1 << 20
# KL(P ‖ Q) after the whole descent: on these near-Gaussian latents the
# descent is chaotic, and the CPU's own KL moves over 3.1737–3.2115 (1.2%)
# when the inputs move by one float32 step; card and CPU read 0.16% and
# 0.85% apart in two runs.
TSNE_KL_RTOL = 0.03
TSNE_NEIGHBOURS = 10
TSNE_PRESERVATION_ATOL = 0.02


def phase_intermediate(counts, card, device="cuda"):
    """Phase 5d (a): the headline VAE-NB on phase 5's split for three
    epochs on ``device`` with an intermediate analyser that records what it
    is given (the card's machine has no matplotlib); returns the run's
    launches."""
    from scvae_tpu_torch import VariationalAutoencoder, ops
    from scvae_tpu_torch.models import vae
    from scvae_tpu_torch.utils.profiling import log_spaced_indices

    shutil.rmtree(INTERMEDIATE_DIRECTORY, ignore_errors=True)
    train, valid = split_counts(counts)
    model = VariationalAutoencoder(
        feature_size=N_GENES, latent_size=LATENT,
        hidden_sizes=[HIDDEN, HIDDEN],
        reconstruction_distribution="negative binomial",
        log_directory=INTERMEDIATE_DIRECTORY)
    calls = []
    ops.reset_launch_counts()
    start = time.perf_counter()
    result = model.train(train, valid, number_of_epochs=AFTER_EPOCHS,
                         minibatch_size=BATCH, seed=0, device=device,
                         verbose=False, analyses_directory="recorded",
                         intermediate_analyser=lambda **call: calls.append(
                             call))
    synchronise(device)
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    check_step_launches("intermediate VAE-NB", launches,
                        result.steps_per_epoch * AFTER_EPOCHS)
    epochs = [call["epoch"] for call in calls]
    want = log_spaced_indices(AFTER_EPOCHS).tolist()
    log(f"check intermediate epochs: {epochs} against {want}")
    if epochs != want:
        raise AssertionError(f"intermediate analyses at epochs {epochs}, "
                             f"the JAX package's at {want}")
    last = calls[-1]
    if not (last["latent_values"].shape == (INTERMEDIATE_ROWS, LATENT)
            and last["model_name"] == model.name
            and last["analyses_directory"] == "recorded"):
        raise AssertionError("intermediate analyser's arguments: "
                             f"{last['latent_values'].shape}, "
                             f"{last['model_name']}")
    state, _ = model._restore(None, False, False, torch.device("cpu"))
    x = torch.from_numpy(
        train[:INTERMEDIATE_ROWS].toarray().astype(np.float32))
    check_close("intermediate latent values (last epoch) against the "
                "stored parameters on the CPU",
                torch.from_numpy(last["latent_values"]),
                vae.latent_means(model.config, state.params,
                                 state.model_state, x), AUTOGRAD_RTOL)
    print(f"intermediate VAE-NB: analyses at epochs {epochs}, "
          f"{last['latent_values'].shape} latent values each; training "
          f"with the analyser {seconds:.4f} s for {AFTER_EPOCHS} epochs; "
          f"launches {({k: v for k, v in launches.items() if v})} ({card})",
          flush=True)
    print(f"seconds 5d (a) intermediate training: {seconds:.4f}", flush=True)
    return launches


def tsne_kl_divergence(p, embedding, device) -> float:
    """KL(P ‖ Q) of a 2-D ``embedding`` (N, 2) under a t-SNE fit's sparse
    P (``TSNE.p_``), with Q the Student-t kernel (one degree of freedom)
    normalised exactly over every pair, in float64 row chunks."""
    from scvae_tpu_torch.analyses.tsne import _row_chunks, _squared_distances

    y = torch.as_tensor(np.asarray(embedding), device=device).double()
    n = y.shape[0]
    rows, columns = p.indices()
    difference = y[rows] - y[columns]
    q = 1.0 / (1.0 + (difference * difference).sum(1))
    sum_q = torch.zeros((), dtype=torch.float64, device=y.device)
    for start, stop in _row_chunks(n, n * 8 * y.shape[1]):
        block = 1.0 / (1.0 + _squared_distances(y, slice(start, stop)))
        sum_q += block.sum() - (stop - start)
    values = p.values()
    return float(torch.sum(values * torch.log(values * sum_q / q)))


def neighbour_preservation(values, embedding, k, device) -> float:
    """The mean share of each row's ``k`` nearest neighbours among the rows
    of ``values`` that are also among its ``k`` nearest in ``embedding``."""
    from scvae_tpu_torch.analyses.tsne import nearest_neighbours

    high, _ = nearest_neighbours(
        torch.from_numpy(np.asarray(values, np.float64)).to(device), k)
    low, _ = nearest_neighbours(
        torch.from_numpy(np.asarray(embedding, np.float64)).to(device), k)
    shared = (high[:, :, None] == low[:, None, :]).any(-1).sum(1)
    return float(shared.double().mean()) / k


def tsne_run(values, device):
    """A 2-D t-SNE of ``values`` on ``device``: (embedding, seconds, KL(P ‖
    Q) of the embedding, 10-nearest-neighbour preservation)."""
    from scvae_tpu_torch.analyses.tsne import TSNE

    model = TSNE(2, 42, device)
    synchronise(device)
    start = time.perf_counter()
    embedding = model.fit_transform(values)
    synchronise(device)
    seconds = time.perf_counter() - start
    return (embedding, seconds,
            tsne_kl_divergence(model.p_, embedding, device),
            neighbour_preservation(values, embedding, TSNE_NEIGHBOURS,
                                   device))


def synchronise(device="cuda") -> None:
    """Wait for the card, where there is one and ``device`` is it."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize()


def phase_embeddings(training_latent, test_latent, card, device="cuda"):
    """Phase 5d (b) and (c): ICA and t-SNE of phase 5c's test latents and
    t-SNE of its training latents on ``device``, and the distance matrix
    of 1,000 rows, against the CPU; returns each part's seconds."""
    from scvae_tpu_torch.analyses.decomposition import FastICA
    from scvae_tpu_torch.analyses.subanalyses import pairwise_distances
    from scvae_tpu_torch.analyses import tsne
    from scvae_tpu_torch.analyses.tsne import TSNE, _SparseObjective

    seconds = {}
    test64 = np.asarray(test_latent, np.float64)
    steps = {}
    for where in (device, "cpu"):
        ica = FastICA(2, 42, where)
        ica.MAXIMUM_ITERATIONS = ICA_CHECKED_STEPS
        steps[where] = ica.fit_transform(test64)
    check_relative(f"ICA of the test latents (float64), "
                   f"{ICA_CHECKED_STEPS} fixed-point steps",
                   steps[device], steps["cpu"])
    ica = FastICA(2, 42, device)
    got = timed(seconds, "ICA (test latents)", ica.fit_transform, test64)
    if not (got.shape == (test64.shape[0], 2) and np.isfinite(got).all()):
        raise AssertionError(f"ICA of the test latents: {got.shape}")
    print(f"ICA of {test64.shape[0]} test latents: {ica.n_iter_} "
          f"fixed-point steps ({card})", flush=True)

    sample = np.sort(np.random.RandomState(0).choice(
        test_latent.shape[0], TSNE_SAMPLE, replace=False))
    values = np.asarray(test_latent[sample])
    parts = {}
    whole = tsne.CHUNK_BYTES
    for where, chunk in ((device, whole), (device, TSNE_SMALL_CHUNK_BYTES),
                         ("cpu", whole)):
        tsne.CHUNK_BYTES = chunk
        try:
            model = TSNE(2, 42, where)
            x = torch.from_numpy(values).to(where)
            p = model.joint_probabilities(x)
            y = model.initial_embedding(x.double())
            _, gradient = _SparseObjective(p, 1)(y, False)
        finally:
            tsne.CHUNK_BYTES = whole
        parts[where, chunk] = (p.to_dense().cpu(), y.cpu(), gradient.cpu())
    for chunk in (whole, TSNE_SMALL_CHUNK_BYTES):
        for index, name, rtol in ((0, "P", ANALYSIS_RTOL),
                                  (1, "PCA start", ANALYSIS_RTOL),
                                  (2, "first gradient", TSNE_GRADIENT_RTOL)):
            check_close(f"t-SNE {name} ({TSNE_SAMPLE} test latents, chunks "
                        f"of {chunk} bytes)", parts[device, chunk][index],
                        parts["cpu", whole][index], rtol)
    _, card_seconds, card_kl, card_kept = tsne_run(values, device)
    _, cpu_seconds, cpu_kl, cpu_kept = tsne_run(values, "cpu")
    log(f"check t-SNE ({TSNE_SAMPLE} test latents): KL {card_kl} on the "
        f"card, {cpu_kl} on the CPU (limit {TSNE_KL_RTOL} relative); "
        f"{TSNE_NEIGHBOURS}-NN preservation {card_kept} / {cpu_kept} "
        f"(limit {TSNE_PRESERVATION_ATOL})")
    if not (abs(card_kl - cpu_kl) <= TSNE_KL_RTOL * cpu_kl
            and abs(card_kept - cpu_kept) <= TSNE_PRESERVATION_ATOL):
        raise AssertionError("t-SNE on the card parts from the CPU's: KL "
                             f"{card_kl} / {cpu_kl}, preservation "
                             f"{card_kept} / {cpu_kept}")
    seconds[f"t-SNE ({TSNE_SAMPLE} test latents)"] = card_seconds
    seconds[f"t-SNE ({TSNE_SAMPLE} test latents, CPU)"] = cpu_seconds
    runs = {}
    for label, latents in (("test", test_latent),
                           ("training", training_latent)):
        embedding, run_seconds, kl, kept = tsne_run(np.asarray(latents),
                                                    device)
        if not (embedding.shape == (latents.shape[0], 2)
                and np.isfinite(embedding).all() and np.isfinite(kl)):
            raise AssertionError(f"t-SNE of the {label} latents: "
                                 f"{embedding.shape}, KL {kl}")
        seconds[f"t-SNE ({latents.shape[0]} {label} latents)"] = run_seconds
        runs[label] = (latents.shape[0], kl, kept)

    rows = test64[:1_000]
    got = timed(seconds, "distances (1,000 test latents)",
                pairwise_distances, rows, device=device)
    check_relative("distances of 1,000 test latents",
                   got, pairwise_distances(rows, "cpu"))
    for part, value in seconds.items():
        print(f"seconds 5d {part}: {value:.4f}", flush=True)
    print("embeddings: " + "; ".join(
        f"t-SNE of {n} {label} latents: KL {kl:.6g}, {TSNE_NEIGHBOURS}-NN "
        f"preservation {kept:.4f}" for label, (n, kl, kept) in runs.items())
        + f"; the {TSNE_SAMPLE}-row sample: KL {card_kl:.6g} (CPU "
        f"{cpu_kl:.6g}), preservation {card_kept:.4f} (CPU {cpu_kept:.4f}) "
        f"({card})", flush=True)
    return seconds


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    from scvae_tpu_torch.ops import extension

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    start = time.perf_counter()
    extension.load_kernels()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)

    # 3. kernels
    counts = make_counts(N_CELLS, N_GENES)
    counts_dev = torch.from_numpy(counts.toarray().astype(np.int16)).cuda()
    kernels = phase_kernels(counts_dev, card)
    del counts_dev
    print("kernels: " + ", ".join(
        f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f}, err {v['max_abs_err']:.3g})"
        for k, v in kernels.items()), flush=True)

    # 4. slice: each kernel's launches in the training runs at the shapes of
    # its entry (NB's kernels at 2,048 rows in the VAE runs, over the
    # GMVAE's 20,480 rows in the GMVAE-NB run)
    launches = dict.fromkeys(kernels, 0)
    shutil.rmtree(SLICE_DIRECTORY, ignore_errors=True)
    data = {3.0: counts}
    for label, model, name, k_max, mean, precision in TRAINED:
        if mean not in data:
            data[mean] = make_counts(N_CELLS, N_GENES, mean=mean)
        run = train_config(label, model, name, k_max, data[mean], card,
                           precision)
        for kernel, count in run.items():
            entry = kernel + "_cycled" if model == "gmvae" else kernel
            if kernel == "gather_rows" or entry in kernels:
                launches[kernel if kernel == "gather_rows" else entry] += count

    # 4a. the headline VAE-NB under trace: NB's kernels at 2,048 rows, K1
    for entry, count in phase_trace(counts, card).items():
        if entry in launches:
            launches[entry] += count

    # 4d. the model options and the rest of the distributions
    for entry, count in phase_options(data, card).items():
        if entry in launches:
            launches[entry] += count

    # 4b. eager against graph; 4c. deferred against sync
    phase_graph_vs_eager(data, card)
    phase_deferred(counts, card)

    # 4e. streaming: NB's kernels at 2,048 rows (VAE-NB-stream), over the
    # GMVAE's 20,480 rows, and at 4,096 genes over the device budget
    for entry, count in phase_streaming(counts, card).items():
        if entry in launches:
            launches[entry] += count
        elif count:
            raise AssertionError(f"streaming launched {entry}")

    # 4f. data parallel on a world of one NCCL rank: K1 and NB's kernels at
    # 2,048 rows (VAE-NB, VAE-NB-stream), over the GMVAE's 20,480 rows
    for entry, count in phase_mesh(counts, card).items():
        if entry in launches:
            launches[entry] += count
        elif count:
            raise AssertionError(f"the mesh runs launched {entry}")

    # 5. after training: the grouped kernels' launches come from this path
    launches.update(phase_after(counts, card))
    # 5b. the data engine: NB's kernels over the golden VAE's 100 rows, the
    # golden GMVAE's 300 and the labelled GMVAE's 20,480 decoder rows, K1
    # on their batches; 5c. the analyses of the labelled GMVAE
    data_launches, latents = phase_data(counts, card)
    for entry, count in data_launches.items():
        if entry in launches:
            launches[entry] += count
    # 5d. the intermediate analyses (VAE-NB: NB's kernels at 2,048 rows, K1)
    # and the figure analyses' computing parts on 5c's latents
    for entry, count in phase_intermediate(counts, card).items():
        if entry in launches:
            launches[entry] += count
    phase_embeddings(*latents, card)
    for name in kernels:
        if "_grouped_" in name and not launches.get(name):
            raise AssertionError(f"{name} was not launched after training")
    # VAE-NB-f32's, VAE-CP-f32's, VAE-Poisson-cat-f32's
    for prefix in ("nb", "cp", "cat_poisson"):
        for kernel in ("forward", "backward_gradient", "backward_dh",
                       "backward_dw"):
            if not launches.get(f"{prefix}_{kernel}_float32"):
                raise AssertionError(f"{prefix}_{kernel}_float32 was not "
                                     "launched in training")

    def source(name):
        if name == "gather_rows":
            return SOURCES["gather"], REPLACES[name]
        kind = "forward" if "forward" in name else "backward"
        if name.startswith("cp_"):
            file = ("product" if "backward_dh" in name or "backward_dw" in name
                    else "cp")
            return SOURCES[file], REPLACES["cp_" + kind]
        if "_grouped_" in name:
            file = ("product" if "backward_dh" in name or "backward_dw" in name
                    else "grouped_tc")
            return SOURCES[file], REPLACES["grouped_" + kind]
        if "backward_dh" in name or "backward_dw" in name:
            file = "product"
        elif name.startswith("cat_"):
            file = "cat_tc"
        else:
            file = "count"
        return SOURCES[file], REPLACES[kind]

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source(name)[0],
         "replaces": source(name)[1], "launches": launches[name], **values}
        for name, values in kernels.items()
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
