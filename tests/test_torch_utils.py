"""The port's profiling tools and download against the JAX package's on the
CPU:

* ``summarize_trace`` on the synthetic Chrome trace of
  ``tests/test_utils.py`` equal to JAX's, and both raising without a trace;
* the port's ``trace`` on ``device="cpu"`` around a small VAE's training:
  a gzip'd Chrome trace where ``jax.profiler`` leaves its own, which both
  packages' ``summarize_trace`` read with the same result;
* ``format_duration`` against JAX's (the spans that replaced
  ``StepTimer``: ``tests/test_torch_tracing.py``);
* ``device_memory_stats(device="cpu")`` against JAX's CPU entry (its
  device's name aside), and raising without a GPU when no device is given;
* ``_download`` of both packages with ``requests.get`` patched to a fake
  streamed response: the same bytes, no ``.part`` file left, and no file
  at all after an HTTP error.  No test reaches an outside host.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from scvae_tpu.data import loading as jloading
from scvae_tpu.utils import profiling as jprofiling
from scvae_tpu.utils import strings as jstrings
from scvae_tpu_torch import VariationalAutoencoder
from scvae_tpu_torch.data import loading
from scvae_tpu_torch.utils import profiling, strings


class FakeResponse:
    """What ``_download`` reads of a streamed ``requests`` response: the
    body in chunks, or an HTTP error status."""

    def __init__(self, body=b"", status=200):
        self.body, self.status = body, status

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def raise_for_status(self):
        import requests

        if self.status >= 400:
            raise requests.HTTPError(f"{self.status} error")

    def iter_content(self, chunk_size=1):
        for start in range(0, len(self.body), chunk_size):
            yield self.body[start:start + chunk_size]


def _synthetic_trace(directory):
    plugin = directory / "plugins" / "profile" / "run1"
    os.makedirs(plugin)
    events = {"traceEvents": [
        {"ph": "X", "name": "fusion.1", "dur": 1500},
        {"ph": "X", "name": "fusion.1", "dur": 500},
        {"ph": "X", "name": "custom-call.2", "dur": 3000},
        {"ph": "M", "name": "process_name", "args": {}},
    ]}
    with gzip.open(plugin / "host.trace.json.gz", "wt") as f:
        json.dump(events, f)


@pytest.mark.parametrize("top", [1, 5])
def test_summarize_trace_matches_jax(tmp_path, top):
    _synthetic_trace(tmp_path)
    got = profiling.summarize_trace(str(tmp_path), top=top)
    assert got == jprofiling.summarize_trace(str(tmp_path), top=top)
    assert got == [{"name": "custom-call.2", "total_ms": 3.0, "count": 1},
                   {"name": "fusion.1", "total_ms": 2.0, "count": 2}][:top]


@pytest.mark.parametrize("module", [profiling, jprofiling],
                         ids=["port", "jax"])
def test_summarize_trace_missing(tmp_path, module):
    with pytest.raises(FileNotFoundError, match="trace.json.gz"):
        module.summarize_trace(str(tmp_path))


def test_trace_of_a_training_run_reads_in_both(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    values = np.random.RandomState(0).poisson(
        2.0, (96, 12)).astype(np.float32)
    model = VariationalAutoencoder(
        feature_size=12, latent_size=2, hidden_sizes=[8],
        reconstruction_distribution="negative binomial")
    with profiling.trace(str(tmp_path / "trace"), device="cpu"):
        model.train(values, number_of_epochs=1, minibatch_size=32,
                    device="cpu", verbose=False)
    (run,) = os.listdir(tmp_path / "trace" / "plugins" / "profile")
    assert len(run) == len("2026_01_31_23_59_59")
    files = os.listdir(tmp_path / "trace" / "plugins" / "profile" / run)
    assert files == [f"{os.uname().nodename}.trace.json.gz"]
    got = profiling.summarize_trace(str(tmp_path / "trace"), top=40)
    assert got == jprofiling.summarize_trace(str(tmp_path / "trace"), top=40)
    names = [entry["name"] for entry in got]
    assert "aten::addmm" in names or "aten::mm" in names
    assert all(entry["count"] >= 1 and entry["total_ms"] >= 0
               for entry in got)
    assert profiling.summarize_trace(str(tmp_path / "trace"), top=None)[
        :40] == got


def test_trace_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("seconds", [0.0, 0.0004, 0.25, 0.9996, 1.0, 59.96,
                                     61.5, 3599.6, 3600.0, 7322.4, 86399.7])
def test_format_duration_matches_jax(seconds):
    assert strings.format_duration(seconds) == jstrings.format_duration(
        seconds)


def test_device_memory_stats_match_jax_on_the_cpu(monkeypatch):
    (got,) = profiling.device_memory_stats(device="cpu")
    assert got["device"] == "cpu"
    for want in jprofiling.device_memory_stats():  # one per CPU device
        assert list(got) == list(want) == ["device", "bytes_in_use",
                                          "bytes_limit"]
        assert (got["bytes_in_use"], got["bytes_limit"]) == (
            want["bytes_in_use"], want["bytes_limit"]) == (None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_memory_stats()


@pytest.mark.parametrize("module", [loading, jloading], ids=["port", "jax"])
def test_download_streams_into_place(tmp_path, monkeypatch, module):
    import requests

    body = bytes(range(256)) * 9_000  # three 1 MiB chunks, the last partial
    calls = []

    def get(url, stream=False, timeout=None):
        calls.append((url, stream, timeout))
        return FakeResponse(body)

    monkeypatch.setattr(requests, "get", get)
    path = tmp_path / "deep" / "er" / "file.bin"
    module._download("https://example.org/file.bin", str(path))
    assert calls == [("https://example.org/file.bin", True, 60)]
    assert path.read_bytes() == body
    assert os.listdir(path.parent) == ["file.bin"]

    monkeypatch.setattr(requests, "get",
                        lambda url, **_: FakeResponse(status=503))
    with pytest.raises(requests.HTTPError, match="503"):
        module._download("https://example.org/gone.bin",
                         str(tmp_path / "gone" / "gone.bin"))
    assert os.listdir(tmp_path / "gone") == []
