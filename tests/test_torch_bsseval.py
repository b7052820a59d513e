"""The port's BSS-eval v4 engines against the JAX package's, on the CPU.

The reference is the JAX package's float64 host engine
(xumx_slicq_tpu.ops.bsseval with use_jax=False): NumPy/SciPy code that
compiles nothing. Tolerances, with their reasons:
* the port's host engine: 1e-9 dB (the same float64 NumPy/SciPy calls in
  the same order; measured bit-equal);
* the port's DeviceBssEval, run here on the CPU in float32: 0.1 dB, the
  bound tests/test_bsseval.py:102 holds the JAX device engine to (float32
  FFT correlations and a Cholesky solve with a 1e-7 ridge against float64
  with a 1e-10 ridge).
"""

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, one_blas_thread  # noqa: F401

from xumx_slicq_tpu.ops import bsseval as J
from xumx_slicq_torch.audio import apply_pcm_scale
from xumx_slicq_torch.ops import bsseval as P

pytestmark = pytest.mark.usefixtures("one_blas_thread")
HOST_ATOL_DB = 1e-9
DEVICE_ATOL_DB = 0.1


def _refs(seed=0, nsrc=4, n=3 * 22050, nchan=2, scale=0.3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nsrc, n, nchan)) * scale


def _assert_scores(a, b, atol):
    assert set(a) == set(b) == set(P.METRICS)
    for m in a:
        assert a[m].shape == b[m].shape, m
        np.testing.assert_allclose(a[m], b[m], rtol=0, atol=atol, err_msg=m)


def _interference():
    refs = _refs(seed=1, nsrc=2)
    ests = refs.copy()
    g = (10 ** (-10 / 20)) * np.std(refs[0]) / np.std(refs[1])
    ests[0] = ests[0] + refs[1] * g          # -10 dB of source 1 in source 0's estimate
    return refs, ests


def _perfect():
    refs = _refs(nsrc=2)
    return refs, refs.copy()


def _partial_window():
    refs = _refs(seed=6, nsrc=2, n=15000)   # shorter than one 22050 window: one partial window
    return refs, refs + 0.1 * np.random.default_rng(7).standard_normal(refs.shape)


def _short_full_fft():
    refs = _refs(seed=8, nsrc=2, n=6000)    # under _BLK_NFFT: the one-FFT path
    return refs, refs + 0.2 * np.random.default_rng(9).standard_normal(refs.shape)


@pytest.mark.parametrize("case", [_perfect, _interference, _partial_window, _short_full_fft],
                         ids=["perfect", "interference", "partial-window", "full-fft"])
def test_host_engine_matches_jax(case):
    refs, ests = case()
    ours = P.bss_eval_images(refs, ests, window=22050, hop=22050)
    ref = J.bss_eval_images(refs, ests, window=22050, hop=22050, use_jax=False)
    _assert_scores(ours, ref, HOST_ATOL_DB)
    if case is _interference:
        assert abs(float(np.median(ours["SIR"][0])) - 10.0) < 0.5
    if case is _partial_window:
        assert ours["SDR"].shape == (2, 1)


def test_eval_track_mono_references_and_aggregation_match_jax():
    """Mono references against stereo estimates (and the other way round)
    are repeated to stereo; the medians of EvalStore agree too."""
    rng = np.random.default_rng(3)
    targets = ["bass", "vocals"]
    refs = {t: rng.standard_normal((12000, 1)) * 0.2 for t in targets}
    ests = {t: np.repeat(refs[t], 2, axis=1) + 0.1 * rng.standard_normal((12000, 2)) for t in targets}
    stores = [P.EvalStore(), J.EvalStore()]
    for (r, e) in ((refs, ests), ({t: ests[t] for t in targets}, {t: refs[t][:11000] for t in targets})):
        ours = P.eval_track(r, e, track_name="t")
        ref = J.eval_track(r, e, track_name="t", use_jax=False)
        for t in targets:
            _assert_scores(ours.targets[t], ref.targets[t], HOST_ATOL_DB)
        stores[0].add_track(ours)
        stores[1].add_track(ref)
    assert stores[0].agg_frames_tracks_scores() == stores[1].agg_frames_tracks_scores()
    assert str(stores[0]) == str(stores[1])
    assert P.fast_sdr(ests["bass"][:, :1], refs["bass"]) == J.fast_sdr(ests["bass"][:, :1], refs["bass"])


def _device_vs_host(eng, refs_raw, ests, host_refs=None):
    """The port's device engine on raw refs against the JAX float64 host
    engine on the same refs scaled; returns the largest |dB| difference."""
    host_refs = apply_pcm_scale(refs_raw) if host_refs is None else host_refs
    host = J.bss_eval_images(host_refs, ests, window=eng.window, hop=eng.hop, filters_len=eng.flen, use_jax=False)
    dev = eng(refs_raw, ests.astype(np.float32))
    _assert_scores(dev, host, DEVICE_ATOL_DB)
    return max(float(np.abs(dev[m] - host[m]).max()) for m in host)


def test_device_engine_matches_jax_host_engine():
    """Two nb_round buckets (9 -> 12 and 15 -> 16 blocks), as
    tests/test_bsseval.py::test_device_engine_matches_host holds the JAX
    engine; and the partial last window masked to the true length."""
    eng = P.DeviceBssEval(window=22050, hop=22050, nb_round=4, device=DEVICE)
    rng = np.random.default_rng(12)
    errs = []
    for seed, n in ((11, 3 * 22050 + 123), (13, 5 * 22050)):
        refs = _refs(seed=seed, nsrc=2, n=n)
        ests = refs + 0.1 * rng.standard_normal(refs.shape)
        assert eng.padded_blocks(n) in (12, 16)
        errs.append(_device_vs_host(eng, refs, ests))
    print(f"DeviceBssEval (CPU, float32) against the JAX float64 host engine: max {max(errs):.3e} dB")
    assert eng.fallbacks == 0


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_device_engine_pcm_staging(dtype):
    """Raw PCM references of every wav dtype the loader takes, staged as
    they are and scaled on the device, against the host engine on the same
    samples scaled in float64 (tests/test_bsseval.py:127-157)."""
    rng = np.random.default_rng(15)
    refs_f = (rng.standard_normal((2, 22050 + 7, 2)) * 0.1).astype(np.float32)
    ests = refs_f + 0.05 * rng.standard_normal(refs_f.shape).astype(np.float32)
    raw = {"int16": lambda: (refs_f * 32768.0).clip(-32768, 32767).astype(np.int16),
           "int32": lambda: (refs_f * 2147483648.0).astype(np.int32),
           "uint8": lambda: np.round(refs_f * 128.0 + 128.0).clip(0, 255).astype(np.uint8),
           "float32": lambda: refs_f}[dtype]()
    eng = P.DeviceBssEval(window=11025, hop=11025, filters_len=128, nb_round=1, device=DEVICE)
    err = _device_vs_host(eng, raw, ests.astype(np.float64))
    print(f"{dtype} staging: max {err:.3e} dB")
    if dtype == "int16":            # int16 / 32768 is exact in float32: the same scores as float staging
        _assert_scores(eng(raw, ests), eng(raw.astype(np.float32) / 32768.0, ests), 1e-4)
    with pytest.raises(ValueError):
        eng(refs_f.astype(np.int64), ests)
    with pytest.raises(ValueError):
        P.eval_track_device({"a": torch.from_numpy(refs_f[0]).long()}, {"a": ests[0]}, eng)


def test_device_engine_falls_back_on_a_gram_that_is_not_positive_definite():
    """A pure tone as one reference: its self-projection Gram has rank 2
    per channel, which the float32 Cholesky cannot factor even with its
    ridge; the float64 host engine can. eval_track_device rescores on the
    host engine and counts it; tensors and a mono side are taken too."""
    n = 3 * 22050 + 123
    refs = _refs(seed=11, nsrc=2, n=n)
    refs[0] = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 44100.0)[:, None]
    ests = refs + 0.1 * np.random.default_rng(5).standard_normal(refs.shape)
    eng = P.DeviceBssEval(window=22050, hop=22050, nb_round=4, device=DEVICE)
    raw = eng(refs.astype(np.float32), ests.astype(np.float32))
    assert not all(np.isfinite(v).all() for v in raw.values())

    targets = ["tone", "noise"]
    r = {t: torch.from_numpy(refs[i, :, :1].astype(np.float32)) for i, t in enumerate(targets)}    # mono
    e = {t: torch.from_numpy(ests[i].astype(np.float32)) for i, t in enumerate(targets)}
    ts = P.eval_track_device(r, e, eng, track_name="tone")
    assert eng.fallbacks == 1
    host = J.eval_track({t: refs[i, :, :1].astype(np.float32) for i, t in enumerate(targets)},
                        {t: ests[i].astype(np.float32) for i, t in enumerate(targets)},
                        window=22050, hop=22050, use_jax=False)
    for t in targets:
        assert all(np.isfinite(v).all() for v in ts.targets[t].values())
        _assert_scores(ts.targets[t], host.targets[t], HOST_ATOL_DB)


def test_device_engine_restores_tf32_flag():
    """The engine's products run in full fp32 and leave a caller's TF32
    choice as it found it."""
    eng = P.DeviceBssEval(window=11025, hop=11025, filters_len=128, nb_round=1, device=DEVICE)
    refs = _refs(seed=2, nsrc=2, n=12000).astype(np.float32)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        eng(refs, refs)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
