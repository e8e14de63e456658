#!/usr/bin/env python3
"""Where the time of a training step goes in the PyTorch/CUDA port.

    python3 tools/profile_torch_step.py [LIKELIHOOD] [--classes K]
        [--model gmvae]

Trains, through ``chip_smoke.train_config_level`` (the config-level
functions, no files written, no full-pass evaluation), the headline VAE of
``chip_smoke.py`` (68,579 × 2,048 synthetic counts, hidden (256, 256),
latent 100, minibatch 2,048) with the
reconstruction likelihood LIKELIHOOD (default "negative binomial"; any name
the port trains, e.g. "zero-inflated negative binomial" or "constrained
poisson"), with K reconstruction classes (the categorised likelihood;
default 0), or the GMVAE of ``chip_smoke.py`` (10 latent clusters), for one
warm-up epoch, then records the second epoch's 33 training steps with
``torch.profiler`` and prints, for that window: the wall time per step, the
device time per step summed over kernels, the device-busy share, and the
device time per step of the 15 largest kernels by name.  Needs one CUDA
device; prints the card's name and power limit with the numbers.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder  # noqa: E402
from scvae_tpu_torch.models import vae  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("likelihood", nargs="?", default="negative binomial")
    parser.add_argument("--classes", type=int, default=0,
                        help="reconstruction classes K (categorised)")
    parser.add_argument("--model", choices=("vae", "gmvae"), default="vae")
    args = parser.parse_args()
    likelihood = args.likelihood
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device is available", file=sys.stderr)
        return 2
    counts = chip_smoke.make_counts(chip_smoke.N_CELLS, chip_smoke.N_GENES)
    kwargs = dict(feature_size=chip_smoke.N_GENES,
                  latent_size=chip_smoke.LATENT,
                  hidden_sizes=(chip_smoke.HIDDEN,) * 2,
                  reconstruction_distribution=likelihood,
                  number_of_reconstruction_classes=args.classes)
    if args.model == "gmvae":  # the API's configuration, which it writes
        config = GaussianMixtureVariationalAutoencoder(
            number_of_latent_clusters=chip_smoke.CLUSTERS, **kwargs).config
    else:
        config = vae.VAEConfig(**kwargs)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def callback(epoch, train_state, metrics):
        torch.cuda.synchronize()
        if epoch == 0:
            prof.start()
            window["start"] = time.perf_counter()
        else:
            window["seconds"] = time.perf_counter() - window["start"]
            prof.stop()

    result = chip_smoke.train_config_level(config, counts,
                                           epoch_callback=callback)
    steps = result.steps_per_epoch
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = window["seconds"] * 1e3 / steps
    print(f"card: {chip_smoke.card_line()}; {args.model}, likelihood: "
          f"{likelihood}, classes: {args.classes}"
          + (f", clusters: {chip_smoke.CLUSTERS}" if args.model == "gmvae"
             else ""))
    print(f"window: {steps} steps, wall {wall_ms:.4f} ms/step, device "
          f"{device_us / 1e3 / steps:.4f} ms/step, busy "
          f"{device_us / 1e3 / steps / wall_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        name = e.key.replace("scvae::(anonymous namespace)::", "")
        print(f"  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:6.1f}/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
