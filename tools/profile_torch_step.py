#!/usr/bin/env python3
"""Where the time of a training step goes in the PyTorch/CUDA port, eager
and graphed.

    python3 tools/profile_torch_step.py [LIKELIHOOD] [--classes K]
        [--model gmvae] [--precision float32]
    python3 tools/profile_torch_step.py --all

Trains, through ``chip_smoke.train_config_level`` (the config-level
functions, no files written, no full-pass evaluation), the headline VAE of
``chip_smoke.py`` (68,579 × 2,048 synthetic counts, hidden (256, 256),
latent 100, minibatch 2,048) with the reconstruction likelihood LIKELIHOOD
(default "negative binomial"; any name the port trains), with K
reconstruction classes (the categorised likelihood; default 0), or the
GMVAE of ``chip_smoke.py`` (10 latent clusters); ``--all`` takes every
configuration that ``chip_smoke.py`` phase 4 trains, on its counts.  Each
configuration trains twice in this process for three epochs from the same
seed: with every step dispatched eagerly, and as CUDA graph replays (the
entry points' default on CUDA).  For each run it prints epoch 2's steps/s
(unprofiled), and for epoch 3, recorded with ``torch.profiler``: the
device time per step summed over kernels, the busy share (that device
time over epoch 2's wall time per step) and the wall time per step under
the profiler.  For the graphed run it also times every replay of epoch 3
with CUDA events around it (device time per step from the replays alone),
since a profiler may show a replay as one ``cudaGraphLaunch``; the events
cost a few microseconds of host time a replay.  One configuration also
prints the 15 largest kernels of each run by device time per step.  Needs
one CUDA device; prints the card's name and power limit with the numbers.
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
from scvae_tpu_torch.models import step  # noqa: E402

EPOCHS = 3  # epoch 2 timed unprofiled, epoch 3 profiled


def run(config, counts, capture: bool) -> dict:
    """Train ``config`` on ``counts``; epoch 2's wall time and epoch 3's
    profile (and, graphed, its replays' CUDA event times)."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    replays: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
    window = {}
    replay = step._GraphedBody.__call__

    def timed_replay(body):
        if not window.get("profiling") or body._graph is None:
            return replay(body)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
        replay(body)
        events[1].record()
        replays.append(events)

    def callback(epoch, train_state, metrics):
        torch.cuda.synchronize()
        if epoch == 1:
            prof.start()
            window["profiling"] = True
            window["start"] = time.perf_counter()
        elif epoch == 2:
            window["seconds"] = time.perf_counter() - window["start"]
            window["profiling"] = False
            prof.stop()

    step._GraphedBody.__call__ = timed_replay
    try:
        result = chip_smoke.train_config_level(
            config, counts, epoch_callback=callback, capture=capture,
            epochs=EPOCHS)
    finally:
        step._GraphedBody.__call__ = replay
    steps = result.steps_per_epoch
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    torch.cuda.synchronize()
    return {
        "steps": steps,
        "steps_per_s": steps / result.epoch_seconds[1],
        "wall_ms": result.epoch_seconds[1] * 1e3 / steps,
        "profiled_wall_ms": window["seconds"] * 1e3 / steps,
        "device_ms": sum(e.self_device_time_total for e in kernels)
        / 1e3 / steps,
        "replay_ms": (sum(a.elapsed_time(b) for a, b in replays) / steps
                      if replays else None),
        "replays": len(replays),
        "kernels": kernels,
    }


def report(label: str, mode: str, out: dict, card: str, top: int) -> None:
    line = (f"{label} {mode}: epoch 2 {out['steps_per_s']:.6g} steps/s "
            f"({out['wall_ms']:.4f} ms/step); epoch 3 ({out['steps']} "
            f"steps) device {out['device_ms']:.4f} ms/step (profiler), busy "
            f"{out['device_ms'] / out['wall_ms']:.3f}, profiled wall "
            f"{out['profiled_wall_ms']:.4f} ms/step")
    if out["replay_ms"] is not None:
        line += (f"; {out['replays']} replays timed by CUDA events "
                 f"{out['replay_ms']:.4f} ms/step, busy "
                 f"{out['replay_ms'] / out['wall_ms']:.3f}")
    print(f"{line} ({card})", flush=True)
    steps = out["steps"]
    for e in sorted(out["kernels"],
                    key=lambda e: -e.self_device_time_total)[:top]:
        name = e.key.replace("scvae::(anonymous namespace)::", "")
        print(f"  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:6.1f}/step  {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("likelihood", nargs="?", default="negative binomial")
    parser.add_argument("--classes", type=int, default=0,
                        help="reconstruction classes K (categorised)")
    parser.add_argument("--model", choices=("vae", "gmvae"), default="vae")
    parser.add_argument("--precision", choices=("float32",), default=None)
    parser.add_argument("--all", action="store_true",
                        help="every configuration of chip_smoke.py phase 4")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    if args.all:
        runs = [(label, model, name, k_max, mean, precision)
                for label, model, name, k_max, mean, precision
                in chip_smoke.TRAINED]
    else:
        label = (f"{args.model} {args.likelihood}, classes {args.classes}"
                 + (f", {args.precision}" if args.precision else ""))
        runs = [(label, args.model, args.likelihood, args.classes,
                 30.0 if args.classes else 3.0, args.precision)]
    counts = {}
    for label, model, name, k_max, mean, precision in runs:
        if mean not in counts:
            counts[mean] = chip_smoke.make_counts(
                chip_smoke.N_CELLS, chip_smoke.N_GENES, mean=mean)
        config = chip_smoke.trained_config(model, name, k_max, precision)
        for capture, mode in ((False, "eager"), (True, "graphed")):
            out = run(config, counts[mean], capture)
            report(label, mode, out, card, 0 if args.all else 15)
    return 0


if __name__ == "__main__":
    sys.exit(main())
