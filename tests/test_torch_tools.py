"""The port's tools against the JAX package's, on the CPU at small sizes:
slicqfinder, tuning, ops.wiener_contrib, visualization, demixui,
utils.profile_stats, the transform's plan helpers and the CLIs.

Tolerances: wiener_contrib's four functions within 1e-5 of the JAX ones
(float32 on both sides, the same formulas); the oracle's in
`test_oracle_matches_jax`; the rest compare pure-Python or NumPy results,
which must be equal. No JAX program is jit-compiled here:
the JAX side runs NumPy and pure-Python functions and a few eager jnp
primitives (wiener_contrib). The port's oracle against the JAX oracle is
`slow` (the JAX transform's first eager call takes about a minute).
"""

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, MEL12, noise, one_thread_env, port_model_dir

from xumx_slicq_torch import data as D
from xumx_slicq_torch.ops.bsseval import fast_sdr
from xumx_slicq_torch.ops.slicqt import SliCQT, make_slicqt


def _cli_refuses_without_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)


def _help(main, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    return capsys.readouterr().out


# -- slicqfinder ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_random_config_matches_jax(seed):
    from xumx_slicq_tpu.slicqfinder import random_config as jax_random_config

    from xumx_slicq_torch.slicqfinder import random_config

    a, b = random.Random(seed), random.Random(seed)
    assert [random_config(a) for _ in range(30)] == [jax_random_config(b) for _ in range(30)]


def test_evaluate_config_guards(monkeypatch):
    from xumx_slicq_torch import slicqfinder

    segments = [D.SyntheticDataset(n_tracks=1, seq_duration=0.5, samples_per_track=1)[0]]
    # a plan that cannot be designed, and sllen > 44100 (73,232): skipped, as the JAX search skips them
    assert slicqfinder.evaluate_config({"fscale": "mel", "fbins": 16, "fmin": 30000.0}, segments, device=DEVICE) is None
    assert slicqfinder.evaluate_config({"fscale": "cqlog", "fbins": 62, "fmin": 20.0}, segments, device=DEVICE) is None
    stats = {}
    ok = slicqfinder.evaluate_config({"fscale": "mel", "fbins": 16, "fmin": 300.0}, segments, device=DEVICE,
                                     stats=stats)
    assert ok is not None and np.isfinite(ok)
    assert set(stats) == {"plan_s", "oracle_s", "score_s", "launches"}
    assert stats["launches"] == dict(synth_assembly=0, wiener_em=0)    # kernel launches: none on the CPU
    per = slicqfinder.evaluate_config({"fscale": "mel", "fbins": 16, "fmin": 300.0}, segments, device=DEVICE,
                                      per_target=True)
    assert per.shape == (4,) and np.mean(per) == pytest.approx(ok)

    # a plan that designs but a transform the port refuses raises: it is not skipped
    def refuse(*a, **k):
        raise AssertionError("a raw synthesis value is read 4 times, expected at most 3")

    monkeypatch.setattr(slicqfinder, "SliCQT", refuse)
    with pytest.raises(AssertionError, match="at most 3"):
        slicqfinder.evaluate_config({"fscale": "mel", "fbins": 16, "fmin": 300.0}, segments, device=DEVICE)


def test_oracle_separation_beats_naive():
    """Oracle Wiener masks with ground-truth magnitudes separate the
    synthetic stems far better than the mix itself as each estimate
    (tests/test_tools.py:11)."""
    from xumx_slicq_torch.slicqfinder import oracle_separate

    seg = D.SyntheticDataset(n_tracks=1, seq_duration=1.0, samples_per_track=1, seed=0)[0]
    t = SliCQT(scale="mel", fbins=32, fmin=100.0, device=DEVICE)
    with torch.inference_mode():
        est = oracle_separate(t, torch.from_numpy(seg[0]), torch.from_numpy(seg[1:])).numpy()
    oracle_sdrs = [fast_sdr(est[i], seg[1 + i]) for i in range(4)]
    naive_sdrs = [fast_sdr(seg[0], seg[1 + i]) for i in range(4)]
    assert np.mean(oracle_sdrs) > np.mean(naive_sdrs) + 5.0
    with torch.inference_mode():
        mixphase = oracle_separate(t, torch.from_numpy(seg[0]), torch.from_numpy(seg[1:]), phasemix=True).numpy()
    assert mixphase.shape == est.shape and np.isfinite(mixphase).all()


@pytest.mark.slow
@pytest.mark.parametrize("phasemix,atol", [(False, 1e-5), (True, 1e-4)], ids=["wiener", "phasemix"])
def test_oracle_matches_jax(phasemix, atol):
    """The oracle against the JAX package's at mel-12 on stems up to ~0.36:
    Wiener within 1e-5 (measured 5.8e-6); mix-phase within 1e-4 (measured
    1.8e-5), because it puts a ground-truth stem magnitude on the phase of
    the mixture coefficient, and where the mixture nearly cancels (|X| ~
    4e-7 against a median of 1e-2, the stem's magnitude 3e-3) the two
    transforms' float32 rounding of X (~3e-8) turns that phase."""
    import jax.numpy as jnp

    from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
    from xumx_slicq_tpu.slicqfinder import oracle_separate as jax_oracle

    from xumx_slicq_torch.slicqfinder import oracle_separate

    seg = D.SyntheticDataset(n_tracks=1, seq_duration=0.5, samples_per_track=1, seed=2)[0]
    ref = np.asarray(jax_oracle(JaxSliCQT(**MEL12), jnp.asarray(seg[0]), jnp.asarray(seg[1:]), phasemix))
    with torch.inference_mode():
        est = oracle_separate(SliCQT(device=DEVICE, **MEL12), torch.from_numpy(seg[0]), torch.from_numpy(seg[1:]),
                              phasemix).numpy()
    np.testing.assert_allclose(est, ref, rtol=0, atol=atol)


def test_slicqfinder_main_and_per_target(tmp_path, capsys):
    from xumx_slicq_torch.slicqfinder import TARGETS, slicqfinder_main

    out = tmp_path / "res.json"
    argv = ["--synthetic-dataset", "--n-iter", "3", "--n-segments", "1", "--seq-dur", "0.5",
            "--output-json", str(out), "--seed", "1", "--device", "cpu"]
    best = slicqfinder_main(argv)
    assert best is not None and np.isfinite(best["oracle_sdr"])
    saved = json.loads(out.read_text())
    assert saved["best"] == best and all(np.isfinite(h["oracle_sdr"]) for h in saved["history"])
    res = slicqfinder_main(argv + ["--per-target"])
    assert set(res["best_per_target"]) == set(TARGETS)
    saved = json.loads(out.read_text())
    assert "best_per_target" in saved
    for h in saved["history"]:
        assert set(h["per_target"]) == set(TARGETS)
        assert np.mean(list(h["per_target"].values())) == pytest.approx(h["oracle_sdr"])
    assert "oracle SDR" in capsys.readouterr().out


# -- tuning -----------------------------------------------------------------------


def test_median_pruner_matches_jax():
    from xumx_slicq_tpu.tuning import MedianPruner as JaxPruner

    from xumx_slicq_torch.tuning import MedianPruner

    rng = np.random.default_rng(0)
    for startup, warmup in ((2, 1), (5, 2), (1, 0)):
        ours, ref = MedianPruner(startup, warmup), JaxPruner(startup, warmup)
        for _ in range(8):
            trial = {e: float(v) for e, v in enumerate(rng.random(4), start=1)}
            for e, v in trial.items():
                assert ours.should_prune(e, v) == ref.should_prune(e, v)
            ours.report_trial(trial)
            ref.report_trial(trial)
        assert ours.history == ref.history


def test_sample_params_matches_jax():
    from xumx_slicq_tpu.tuning import sample_params as jax_sample

    from xumx_slicq_torch.tuning import sample_params

    a, b = random.Random(7), random.Random(7)
    assert [sample_params(a) for _ in range(20)] == [jax_sample(b) for _ in range(20)]


def test_objective_reports_only_completed_trials(monkeypatch, tmp_path):
    """tests/test_tuning.py's case with the same namespace, which has no
    grouped_wiener (nor device): the port reads optional flags with
    defaults. A pruned trial's intermediates stay out of the pruner's
    history (optuna MedianPruner semantics)."""
    import xumx_slicq_torch.training as T
    from xumx_slicq_torch.tuning import MedianPruner, objective

    vals, argvs = {}, []

    def fake_training_main(argv, epoch_callback=None):
        argvs.append(argv)
        out = []
        for e, v in enumerate(vals["v"], start=1):
            out.append(v)
            if epoch_callback and epoch_callback(e, v, v):
                break
        return None, out

    monkeypatch.setattr(T, "training_main", fake_training_main)
    args = SimpleNamespace(
        study_dir=str(tmp_path), trial_epochs=3, batch_size=1, seq_dur=0.1,
        fscale="mel", fbins=12, fmin=200.0, samples_per_track=1,
        max_valid_samples=1, synthetic_dataset=True, musdb_root="",
        max_batches_per_epoch=-1,
    )
    params = {"hidden_size_1": 8, "hidden_size_2": 8, "time_filter_2": 3}
    pruner = MedianPruner(n_startup_trials=2, n_warmup_steps=0)

    vals["v"] = [1.0, 1.0, 1.0]
    _, pruned, _ = objective(params, args, pruner, 0)
    assert not pruned
    vals["v"] = [2.0, 2.0, 2.0]
    _, pruned, _ = objective(params, args, pruner, 1)
    assert not pruned and len(pruner.history) == 2

    vals["v"] = [9.0, 9.0, 9.0]  # worse than median(1,2) -> pruned at e1
    _, pruned, inter = objective(params, args, pruner, 2)
    assert pruned and 1 in inter
    assert len(pruner.history) == 2  # pruned trial stays OUT of the history
    argv = argvs[0]
    assert argv[argv.index("--device") + 1] == "cuda" and "--grouped-wiener" not in argv
    assert argv[argv.index("--valid-metric") + 1] == "sdr" and "--synthetic-dataset" in argv


def test_tuning_cpu_smoke(tmp_path):
    """Two 2-epoch trials of the port's trainer at mel-12, 0.3 s: the study
    records finite objectives for both epochs, and each trial's manifest
    the SDR validation metric."""
    from xumx_slicq_torch.tuning import tuning_main

    best = tuning_main([
        "--study-dir", str(tmp_path), "--n-trials", "2", "--trial-epochs", "2",
        "--batch-size", "4", "--seq-dur", "0.3", "--fscale", "mel", "--fbins", "12", "--fmin", "200.0",
        "--synthetic-dataset", "--max-batches-per-epoch", "2", "--device", "cpu",
    ])
    study = json.loads((tmp_path / "study.json").read_text())
    assert len(study["trials"]) == 2
    assert all("error" not in t and np.isfinite(t["value"]) for t in study["trials"])
    assert best is not None and np.isfinite(best["value"])
    assert set(map(int, study["trials"][0]["intermediate"])) == {1, 2}
    m = json.loads((tmp_path / "trial_0" / "xumx_slicq_tpu.json").read_text())
    assert m["args"]["valid_metric"] == "sdr" and m["args"]["mask_sum_coef"] == 0.0
    assert m["args"]["hidden_size_1"] == study["trials"][0]["params"]["hidden_size_1"]


def test_tuning_trial_trains_in_one_process_on_several_cards(monkeypatch, tmp_path):
    """On a host with 4 cards a trial still trains in one process (its
    pruning callback cannot follow ranks), where the trainer's default
    --n-devices -1 would take every card. The host here claims 4 cards and
    the trainer's "cuda" resolves to the CPU."""
    import xumx_slicq_torch.device as dev_mod
    import xumx_slicq_torch.training as T
    from xumx_slicq_torch.tuning import tuning_main

    def on_cpu(device="cuda"):
        return torch.device("cpu")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dev_mod, "resolve_device", on_cpu)
    monkeypatch.setattr(T, "resolve_device", on_cpu)
    tuning_main([
        "--study-dir", str(tmp_path), "--n-trials", "1", "--trial-epochs", "1",
        "--batch-size", "4", "--seq-dur", "0.3", "--fscale", "mel", "--fbins", "12", "--fmin", "200.0",
        "--synthetic-dataset", "--max-batches-per-epoch", "1",
    ])
    (trial,) = json.loads((tmp_path / "study.json").read_text())["trials"]
    assert "error" not in trial, trial["error"]
    assert np.isfinite(trial["value"])


# -- wiener_contrib and the grouped Wiener API ------------------------------------


def test_wiener_contrib_matches_jax():
    import jax.numpy as jnp

    from xumx_slicq_tpu.ops import wiener_contrib as JWC

    from xumx_slicq_torch.ops import wiener_contrib as WC

    rng = np.random.default_rng(0)
    B, F, N, C, S = 1, 7, 5, 2, 4
    v = np.abs(rng.standard_normal((B, F, N, C, S))).astype(np.float32)
    x = (rng.standard_normal((B, F, N, C)) + 1j * rng.standard_normal((B, F, N, C))).astype(np.complex64)
    for autoscale in (False, True):
        ours = WC.residual_model(torch.from_numpy(v), torch.from_numpy(x), 1, autoscale).numpy()
        ref = np.asarray(JWC.residual_model(jnp.asarray(v), jnp.asarray(x), 1, autoscale))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    w = rng.standard_normal((20, 8))
    for temporal in (False, True):
        np.testing.assert_array_equal(WC.smooth(torch.from_numpy(w), 2, temporal), JWC.smooth(w, 2, temporal))
    vv = np.abs(rng.standard_normal((6, 9, 3))).astype(np.float32)
    np.testing.assert_allclose(WC.reduce_interferences(torch.from_numpy(vv)).numpy(),
                               np.asarray(JWC.reduce_interferences(jnp.asarray(vv))), rtol=1e-5, atol=1e-5)
    W2 = (rng.standard_normal((3, 4, 2, 2)) + 1j * rng.standard_normal((3, 4, 2, 2))).astype(np.complex64)
    W1 = rng.random((3, 4, 1, 1)).astype(np.float32)
    for Wm in (W2, W1):
        np.testing.assert_allclose(WC.compress_filter(torch.from_numpy(Wm)).numpy(),
                                   np.asarray(JWC.compress_filter(jnp.asarray(Wm))), rtol=1e-5, atol=1e-5)


def test_partition_by_m_matches_jax_and_grouped_wiener_is_per_bucket():
    from xumx_slicq_tpu.ops.wiener import partition_by_m as jax_partition

    from xumx_slicq_torch.ops import wiener as W

    t = SliCQT(device=DEVICE, **MEL12)
    Ms, Fs = [b.M for b in t.buckets], [b.f_count for b in t.buckets]
    for n in (1, 3, 8):
        assert W.partition_by_m(Ms, Fs, n) == jax_partition(Ms, Fs, n)
    x = t.forward(torch.from_numpy(noise(4, (1, 2, 9000), 0.1)))
    mags = [torch.rand((4,) + b.shape, generator=torch.Generator().manual_seed(k)) for k, b in enumerate(x)]
    grouped = W.wiener_blocks_grouped(x, mags, classes=W.partition_by_m(Ms, Fs, 3))
    for a, b in zip(grouped, W.wiener_blocks(x, mags)):
        assert torch.equal(a, b)


# -- transform, visualization, demixui ---------------------------------------------


def test_slicqt_plan_helpers_match_jax():
    from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT

    ours, ref = make_slicqt(device=DEVICE, **MEL12), JaxSliCQT(**MEL12)
    assert ours.coef_factors() == ref.coef_factors()
    assert ours.fbins_actual == ref.fbins_actual == ours.nfreqs
    assert (make_slicqt(device=DEVICE).scale_name, make_slicqt(device=DEVICE).fbins) == ("bark", 262)


def test_overlap_add_slicq_matches_jax():
    from xumx_slicq_tpu.visualization import overlap_add_slicq as jax_ola

    from xumx_slicq_torch.visualization import overlap_add_slicq

    x = np.random.default_rng(1).standard_normal((2, 3, 5, 8)).astype(np.float32)
    for flatten in (False, True):
        np.testing.assert_array_equal(overlap_add_slicq(x, flatten), jax_ola(x, flatten))


def test_visualization_plots(tmp_path):
    pytest.importorskip("matplotlib")
    from xumx_slicq_torch.audio import save_audio
    from xumx_slicq_torch.visualization import visualization_main

    wav = tmp_path / "sig.wav"
    save_audio(wav, noise(5, (2, 22050), 0.2), 44100)
    outdir = tmp_path / "plots"
    visualization_main(["--input-wav", str(wav), "--output-dir", str(outdir), "--fscale", "mel", "--fbins", "16",
                        "--fmin", "300.0", "--device", "cpu"])
    assert len(list(outdir.glob("*.png"))) == len(SliCQT(scale="mel", fbins=16, fmin=300.0, device=DEVICE).buckets)


def test_stream_demix_takes_a_gain_change_mid_stream():
    """stream_demix re-reads the mutable gains each chunk, so a keypress
    between chunks changes the mix from the next chunk on."""
    from xumx_slicq_torch.demixui import apply_key, stream_demix

    class FakeSeparator:
        sample_rate = 100

        def __call__(self, seg):
            n = seg.shape[-1]          # stem k separates to the constant k + 1
            return np.arange(1, 5, dtype=np.float32)[:, None, None, None] * np.ones((4, 1, 1, n), np.float32)

    gains = [1.0, 1.0, 1.0, 1.0]
    chunks, levels = [], []
    for remix, lv in stream_demix(FakeSeparator(), np.zeros((1, 1, 300), np.float32), gains, chunk_seconds=1.0):
        chunks.append(float(remix[0, 0, 0]))
        levels.append(lv)
        assert apply_key("v", gains)   # vocals down 0.1 after each chunk
    assert chunks == pytest.approx([10.0, 1 + 2 * 0.9 + 3 + 4, 1 + 2 * 0.8 + 3 + 4])
    np.testing.assert_allclose(levels[0], [1, 2, 3, 4])


def test_stream_demix_with_the_port_separator(tmp_path):
    """The real Separator through stream_demix: the remix at unit gains is the
    sum of the stems, chunk by chunk."""
    from xumx_slicq_torch.demixui import stream_demix
    from xumx_slicq_torch.separator import Separator

    sep = Separator.load(model_path=port_model_dir(tmp_path / "m"), device=DEVICE, chunk_size=16384)
    x = noise(6, (1, 2, 25000), 0.1)
    gains = [1.0, 0.0, 1.0, 1.0]
    parts = list(stream_demix(sep, x, gains, chunk_seconds=0.25))        # chunks of 11,025 samples
    assert [p[0].shape[-1] for p in parts] == [11025, 11025, 2950]
    est = sep(x[..., :11025])
    np.testing.assert_allclose(parts[0][0], est[[0, 2, 3]].sum(0), rtol=0, atol=1e-6)


def test_apply_key_and_meters_match_jax():
    from xumx_slicq_tpu.demixui import STEMS as JAX_STEMS
    from xumx_slicq_tpu.demixui import _render_meters as jax_meters
    from xumx_slicq_tpu.demixui import apply_key as jax_apply_key

    from xumx_slicq_torch.demixui import STEMS, _render_meters, apply_key

    assert list(STEMS) == list(JAX_STEMS) == ["bass", "vocals", "other", "drums"]
    ours, ref = [0.05, 1.95, 1.0, 1.0], [0.05, 1.95, 1.0, 1.0]
    for key in "bBvVoOdDxX" * 3 + "q":
        assert apply_key(key, ours) == jax_apply_key(key, ref)
        assert ours == ref
    assert _render_meters([0.01, 0.2, 0.05, 0.0], ours) == jax_meters([0.01, 0.2, 0.05, 0.0], ref)


# -- utils ------------------------------------------------------------------------


def test_profile_stats_on_a_cpu_profile(tmp_path, capsys):
    """The aggregator's host self-times and stage times against
    torch.profiler's own key_averages of the same CPU profile, within 1%."""
    from torch.profiler import record_function

    from xumx_slicq_torch.utils import device_platform, profile_trace
    from xumx_slicq_torch.utils.profile_stats import main, summarize

    assert device_platform() == ("gpu" if torch.cuda.is_available() else "cpu")
    x = torch.randn(200, 200)
    with profile_trace(tmp_path) as prof:
        for _ in range(3):
            with record_function("stage_a"):
                y = x @ x
                with record_function("stage_b"):
                    torch.fft.rfft(y)
    agg = summarize(tmp_path / "trace.json", runs=3)
    ka = {e.key: e for e in prof.key_averages()}
    assert agg["device_ms"] == 0.0 and agg["stages_device_ms"] == {}
    for name in ("aten::mm", "aten::_fft_r2c"):
        count, ms = agg["host_ops"][name]
        assert count == ka[name].count / 3
        assert ms == pytest.approx(ka[name].self_cpu_time_total / 1e3 / 3, rel=1e-2)
    for stage in ("stage_a", "stage_b"):
        assert agg["stages_host_ms"][stage] == pytest.approx(ka[stage].cpu_time_total / 1e3 / 3, rel=1e-2)
    assert main([str(tmp_path / "trace.json"), "--runs", "3"]) == 0
    assert "aten::mm" in capsys.readouterr().out
    assert main([str(tmp_path / "trace.json"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["runs"] == 1


def test_profile_stats_attributes_device_events_to_stages():
    """Device events reach the innermost stage open at their launch, through
    the launch's correlation id (a hand-built card trace)."""
    from xumx_slicq_torch.utils.profile_stats import aggregate

    ev = [
        dict(ph="X", cat="user_annotation", name="outer", pid=1, tid=1, ts=0.0, dur=100.0),
        dict(ph="X", cat="user_annotation", name="inner", pid=1, tid=1, ts=10.0, dur=20.0),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=1, tid=1, ts=15.0, dur=2.0,
             args={"correlation": 1}),
        dict(ph="X", cat="cuda_driver", name="cuLaunchKernelEx", pid=1, tid=1, ts=50.0, dur=2.0,
             args={"correlation": 2}),
        dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", pid=1, tid=1, ts=150.0, dur=2.0,
             args={"correlation": 3}),
        dict(ph="X", cat="kernel", name="k_a", pid=0, tid=7, ts=20.0, dur=5.0, args={"correlation": 1}),
        dict(ph="X", cat="kernel", name="k_b", pid=0, tid=7, ts=60.0, dur=7.0, args={"correlation": 2}),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", pid=0, tid=8, ts=155.0, dur=1.0,
             args={"correlation": 3}),
    ]
    agg = aggregate(ev, runs=2)
    assert agg["device_ms"] == pytest.approx(13e-3 / 2) and agg["device_events"] == 1.5
    assert agg["stages_device_ms"] == pytest.approx({"inner": 2.5e-3, "outer": 3.5e-3, "(no stage)": 0.5e-3})
    assert agg["kernels"]["k_b"] == [0.5, pytest.approx(3.5e-3)]


# -- CLIs ----------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["slicqfinder", "tuning", "visualization", "demixui", "inference"])
def test_cli_help_and_needs_a_card(tool, tmp_path, capsys):
    import importlib

    mod = importlib.import_module(f"xumx_slicq_torch.{tool}")
    main = getattr(mod, f"{tool}_main")
    text = _help(main, capsys)
    assert "--device" in text
    if tool == "inference":
        assert "--grouped-wiener" in text and "--synth-staging" in text and text.count("no effect") >= 2
        return
    wav = tmp_path / "a.wav"
    from xumx_slicq_torch.audio import save_audio

    save_audio(wav, noise(0, (2, 1000), 0.1), 44100)
    argv = dict(
        slicqfinder=["--synthetic-dataset", "--n-iter", "1"],
        tuning=["--study-dir", str(tmp_path / "s"), "--synthetic-dataset", "--n-trials", "1"],
        visualization=["--input-wav", str(wav), "--output-dir", str(tmp_path / "p")],
        demixui=["--input", str(wav), "--model-path", str(tmp_path)],
    )[tool]
    _cli_refuses_without_card(main, argv)
    assert not (tmp_path / "s" / "study.json").exists()


def test_package_surface():
    import subprocess
    import sys
    from pathlib import Path

    import xumx_slicq_torch

    assert xumx_slicq_torch.SliCQT is SliCQT
    with pytest.raises(AttributeError):
        xumx_slicq_torch.NoSuchThing
    res = subprocess.run([sys.executable, "-m", "xumx_slicq_torch", "--help"], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parent.parent, env=one_thread_env())
    assert res.returncode == 0 and "--input-dir" in res.stdout
