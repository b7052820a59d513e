"""The yardstick's arithmetic against values worked out by hand: each
kernel's work count on a small layout, the roofline share, and the
reduction of a hand-made trace."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import harness  # noqa: E402
import traces  # noqa: E402
from work import k1, k2, k3, k4, k5, model  # noqa: E402


def test_k1_bytes_are_the_spectra_in_and_the_half_spectrum_out():
    # 2 rows x 3 slices: 10 raw values in, 5 half-spectrum positions out, 8 B each
    assert k1.work([[2, 3, 10], [5, 4], [5, 4], [5, 4], [2, 5]], None) == (0.0, 8 * 2 * 3 * (10 + 5))


def test_k2_bytes_are_56_an_element_of_the_mixture():
    # x 6 complex (48 B), v 24 float (96 B), y 24 complex (192 B)
    assert k2.work([[6], [24], [3, 6], [9, 3], [9, 3], []], None) == (0.0, 336.0)


def test_k3_bytes_are_the_half_spectrum_in_and_the_coefficients_out():
    assert k3.work([[2, 3, 7], [4, 4], [2, 4]], None) == (0.0, 8 * 2 * 3 * (7 + 4))


GEOM = {"channels": 2, "targets": 4, "slices": 2, "buckets": [(3, 4)], "fphi": [1], "lstm_hidden": [2],
        "hidden_size_1": 5, "hidden_size_2": 6, "time_filter_2": 2}


def test_k4_counts_one_bucket_by_hand():
    # B 1, C 2, F 3, S 2, T 4, fphi 1; 4 targets, h1 5, h2 6, tf2 2, offline:
    # F1 3, K1 3, F2 3, K2 2; a1 = 4*5*3*3 = 180, a2 = 4*6*3*2 = 144;
    # every layer 1440 MACs (180*2*4, 144*5*2, 144*5*2, 180*2*4)
    concrete = ["", "", "", "", "", "", "", "0", ""]
    ops, nbytes = k4.work([[48]], concrete, GEOM)
    assert ops == 2 * 4 * 1440
    assert k4.work([[96]], concrete, GEOM)[0] == 2 * ops          # a chunk batch of 2
    with pytest.raises(ValueError):
        k4.work([[50]], concrete, GEOM)
    a0 = 2 * 3 * 2 * 4
    weights = 4 * (2 * 5 * 2 * 1 * 4 + 2 * 6 * 5 * 1 * 2 + 5 + 6 + 5 + 2)
    assert nbytes == 8 * a0 + 4 * weights + 2 * 4 * 4 * a0


def test_k5_counts_two_buckets_by_hand():
    # buckets M 5 (H 2) and M 10 (H 3) over S 2 slices: 10 and 20 steps; batch 2, 2 directions, 4 targets:
    # xp = 16 x 2 x (5 x 8 + 10 x 12) = 5120 values
    geom = dict(GEOM, buckets=[(3, 5), (12, 10)], lstm_hidden=[2, 3])
    concrete = ["", "", "", "0", "", "", "2", "2", "4"]
    ops, nbytes = k5.work([[5120], [300]], concrete, geom)
    assert ops == 160 * (8 * 4 + 20) + 320 * (8 * 9 + 30)
    assert nbytes == 4 * (5120 + 300 + 160 * 2 + 320 * 3)


def test_roofline_is_least_time_over_device_time():
    calls = [{"dims": [[2, 3, 10], [5, 4]], "concrete": None, "device_s": 2 * 720 / 3.35e12}]
    assert harness.roofline({"ops": {k1.OP: calls}, "geometry": GEOM}, "k1") == pytest.approx(50.0)
    assert harness.roofline({"ops": {}, "geometry": GEOM}, "k1") is None


def test_model_ops_count_the_cdae_convs_and_ffts():
    config = {"transform": {"scale": "mel", "fbins": 12, "fmin": 200.0, "fs": 44100.0}, "nb_channels": 2,
              "model": "cdae", "hidden_size_1": 50, "hidden_size_2": 51, "time_filter_2": 4, "chunk_size": 8192}
    plan, S = model._plan_slices(config, 8192)
    convs = sum(2 * sum(k4.layer_macs(1, 2, b.f_count, S, b.M, 1 if b.f_count < 10 else 3, 4, 50, 51, 4))
                for b in plan.buckets)
    assert model.mask_model_ops(config, 1, 8192) == convs
    assert model.demix_chunk_ops(config) == convs + model.transform_ops(config, 1, 8192)
    assert model.train_step_ops(config, 3, 8192) == 5 * model.transform_ops(config, 3, 8192, synthesis=False) \
        + 3 * model.mask_model_ops(config, 3, 8192)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def test_trace_reduction_by_hand():
    events = [
        _ev("user_annotation", "bench.window", 0, 100),
        _ev("user_annotation", "slicqt_forward", 10, 30),
        _ev("cpu_op", "xumx_slicq::analysis_gather", 12, 5, **{"Input Dims": [[1, 1, 4], [2, 4], [2, 2]],
                                                               "Concrete Inputs": ["", "", ""]}),
        _ev("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=8),
        _ev("cpu_op", "aten::copy_", 60, 30),
        _ev("cuda_runtime", "cudaMemcpyAsync", 61, 1, correlation=9),
        _ev("kernel", "k3", 20, 10, tid=7, correlation=7),
        _ev("kernel", "fft", 35, 10, tid=7, correlation=8),
        _ev("gpu_memcpy", "Memcpy DtoH", 70, 40, tid=7, correlation=9),     # runs past the window's end
    ]
    s = traces.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)                        # 20-30, 35-45, 70-100
    assert s["device_events"] == 3
    assert s["memcpy_s"] == pytest.approx(40e-6)
    assert s["stage_s"]["slicqt_forward"] == pytest.approx(20e-6)
    assert [c["device_s"] for c in s["ops"]["xumx_slicq::analysis_gather"]] == [pytest.approx(10e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["slicqt_forward"] == pytest.approx(25e-6)              # 0-20 and 30-35, named at their middles
    assert gaps["(python, no op)"] == pytest.approx(25e-6)             # 45-70
    assert sum(gaps.values()) == pytest.approx(50e-6)
