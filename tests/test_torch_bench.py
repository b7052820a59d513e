"""bench_torch.py, the port's bench, on the CPU at a small size: every mode
prints exactly one line of JSON on stdout with a finite, positive value,
records it in the history file it is given (never the JAX package's
BENCH_HISTORY.json), and the CLI dispatches each flag to its mode."""

import json
import math

import pytest

import bench_torch
import xumx_slicq_torch.evaluation  # noqa: F401  (the modes import them when they run)
import xumx_slicq_torch.training  # noqa: F401
from torch_port_utils import DEVICE, MEL12, one_blas_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_blas_thread")
SMALL = dict(device=DEVICE, geometry=MEL12)
MODES = {
    "inference": (lambda h: bench_torch.bench_inference(track_seconds=0.3, chunk=16384, steady_runs=1, history=h,
                                                        **SMALL), "inference_time_per_track_s"),
    "realtime": (lambda h: bench_torch.bench_inference(realtime=True, track_seconds=0.4, chunk=16384, steady_runs=1,
                                                       history=h, **SMALL), "realtime_inference_time_per_track_s"),
    "attribution": (lambda h: bench_torch.bench_attribution(track_seconds=0.3, chunk=16384, steady_runs=1, history=h,
                                                            **SMALL), "inference_wall_attribution_ms"),
    "streaming-lstm": (lambda h: bench_torch.bench_streaming(lstm=True, chunk_dur_s=0.02, n_chunks=2, history=h,
                                                             **SMALL), "streaming_chunk_latency_s_lstm"),
    "train-step": (lambda h: bench_torch.bench_train_step(batch=2, seconds=0.2, steps=1, history=h, **SMALL),
                   "train_step_time_s"),
    "eval-host": (lambda h: bench_torch.bench_eval_throughput(n_tracks=1, track_seconds=0.3, chunk=16384, reps=1,
                                                              history=h, **SMALL), "eval_track_time_host_bss_s"),
    "eval-devres": (lambda h: bench_torch.bench_eval_throughput(n_tracks=1, track_seconds=0.3, chunk=16384, reps=1,
                                                                device_resident=True, history=h, **SMALL),
                    "eval_track_time_devres_bss_s"),
    "data-loader": (lambda h: bench_torch.bench_data_loader(batch=2, seq_dur=0.2, n_batches=2, workers=2,
                                                            track_s=0.5, n_tracks=2, history=h, **SMALL),
                    "data_loader_batch_time_s"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prints_one_json_line(mode, tmp_path, capsys):
    run, metric = MODES[mode]
    history = tmp_path / "history.json"
    run(history)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert out["metric"] == metric and out["device"] == "cpu"
    for key in ("value", "vs_baseline"):
        assert math.isfinite(out[key]) and out[key] > 0, out
    assert json.loads(history.read_text())[metric]["value"] == out["value"]


def test_cli_dispatches_every_flag(monkeypatch):
    """Each flag reaches its mode with the CLI's settings; the default
    history file is the port's own."""
    seen = []
    names = ["bench_inference", "bench_attribution", "bench_streaming", "bench_train_step",
             "bench_eval_throughput", "bench_data_loader"]
    for name in names:
        monkeypatch.setattr(bench_torch, name, lambda name=name, **kw: seen.append((name, kw)))
    for argv in ([], ["--realtime", "--lstm"], ["--attribution"], ["--streaming", "--stream-chunk-dur", "1.5"],
                 ["--train-step", "--batch", "8", "--bf16"], ["--data-loader"],
                 ["--eval-throughput", "--eval-tracks", "2", "--device-resident"]):
        bench_torch.main(["--device", "cpu", *argv])
    assert [s[0] for s in seen] == ["bench_inference", "bench_inference", "bench_attribution", "bench_streaming",
                                    "bench_train_step", "bench_data_loader", "bench_eval_throughput"]
    assert all(kw["device"] == "cpu" for _, kw in seen)
    assert seen[1][1]["realtime"] and seen[1][1]["lstm"]
    assert seen[3][1]["chunk_dur_s"] == 1.5
    assert seen[4][1]["batch"] == 8 and seen[4][1]["bf16"]
    assert seen[6][1]["n_tracks"] == 2 and seen[6][1]["device_resident"]
    assert bench_torch.HISTORY_PATH.name == "BENCH_TORCH_HISTORY.json"


def test_bench_needs_explicit_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_torch.bench_inference(geometry=MEL12, history=None)
