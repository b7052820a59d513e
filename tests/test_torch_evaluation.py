"""The port's evaluator against the JAX package's, on the CPU.

* run_parallel_evaluation with injected separate and score functions:
  the overlap of separation and scoring, error propagation, and the same
  EvalStore as the JAX package's run_parallel_evaluation on the same
  functions (the scorer is pure NumPy: no JAX program runs);
* evaluation_main --device cpu on a synthetic MUSDB tree (two tracks of
  25,000 int16 samples) with a mel-12 model from the port's seeded Unmix:
  the host, --bss-on-device and --device-resident runs agree on aggregate
  SDR within 0.1 dB (the float32 engine's bound, tests/test_bsseval.py:102);
  the host run's per-track scores equal the JAX float64 host engine's on
  the port's own stems within 1e-9 dB (the same NumPy/SciPy calls); JSON
  shards round-trip through both packages' merge_results.
No JAX Separator or model is built: the JAX side is its NumPy scorer and
its pure-Python pipeline.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_port_utils import DEVICE, MEL12, TINY_ARGS, TINY_LEN, one_blas_thread  # noqa: F401

from xumx_slicq_tpu import evaluation as jeval
from xumx_slicq_tpu.ops import bsseval as jbss
from xumx_slicq_torch import evaluation as E
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models.convert import to_reference_state_dict
from xumx_slicq_torch.ops.bsseval import TrackScores
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator

pytestmark = pytest.mark.usefixtures("one_blas_thread")
SDR_MODES_DB = 0.1
HOST_ATOL_DB = 1e-9
CHUNK = "30000"


def test_parallel_evaluation_overlaps_separation_and_scoring():
    """4 separation workers: separations overlap each other and scoring,
    and results stream while separations run (the JAX package's
    tests/test_eval_multidevice.py:20-79, same latencies)."""
    lock = threading.Lock()
    active, max_active = set(), [0]
    scoring_during_separation, separations_done, results_seen_mid_run = [0], [0], [0]

    def fake_separate(sep, td):
        with lock:
            active.add(sep)
            max_active[0] = max(max_active[0], len(active))
        time.sleep(0.3)
        with lock:
            active.discard(sep)
            separations_done[0] += 1
        return td

    def fake_score(payload, td):
        with lock:
            if active:
                scoring_during_separation[0] += 1
        time.sleep(0.15)
        return TrackScores(name=str(td), targets={"bass": {"SDR": np.zeros(1)}})

    def on_result(ts):
        with lock:
            if separations_done[0] < len(tracks):
                results_seen_mid_run[0] += 1

    tracks = list(range(8))
    t0 = time.time()
    res = E.run_parallel_evaluation(tracks, ["dev0", "dev1", "dev2", "dev3"], separate_fn=fake_separate,
                                    score_fn=fake_score, on_result=on_result)
    wall = time.time() - t0
    assert [r.name for r in res] == [str(i) for i in tracks]
    assert max_active[0] >= 3, f"separations did not overlap (max {max_active[0]})"
    assert scoring_during_separation[0] > 0, "scoring never overlapped separation"
    assert results_seen_mid_run[0] > 0, "on_result only fired after all separations"
    assert wall < 1.8, f"pipeline too slow ({wall:.2f}s): not parallel"


def test_parallel_evaluation_propagates_errors():
    def bad_separate(sep, td):
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="evaluation failed") as exc:
        E.run_parallel_evaluation([1, 2], ["dev0"], separate_fn=bad_separate, score_fn=lambda p, td: None)
    assert isinstance(exc.value.__cause__, ValueError)

    def bad_score(payload, td):
        raise KeyError(td)

    with pytest.raises(RuntimeError, match="evaluation failed"):
        E.run_parallel_evaluation([1, 2], ["dev0"], separate_fn=lambda s, td: td, score_fn=bad_score)


def test_parallel_evaluation_matches_jax_pipeline():
    """The same injected functions through both packages' pipelines (two
    workers, three scoring threads) give the same stores."""
    rng = np.random.default_rng(0)
    stems = {i: (rng.standard_normal((2, 3000, 1)) * 0.2, rng.standard_normal((2, 3000, 1)) * 0.2)
             for i in range(3)}

    def separate(sep, td):
        refs, noise = stems[td]
        return {"bass": refs[0], "drums": refs[1]}, {"bass": refs[0] + 0.3 * noise[0], "drums": refs[1] + noise[1]}

    def score(payload, td):
        return jbss.eval_track(payload[0], payload[1], track_name=str(td), use_jax=False)

    ours = E.run_parallel_evaluation(list(stems), ["a", "b"], eval_workers=3, separate_fn=separate, score_fn=score)
    ref = jeval.run_parallel_evaluation(list(stems), ["a", "b"], eval_workers=3, separate_fn=separate,
                                        score_fn=score)
    stores = [E.EvalStore(), jbss.EvalStore()]
    for a, b in zip(ours, ref):
        stores[0].add_track(a)
        stores[1].add_track(b)
    assert [t.name for t in ours] == [t.name for t in ref]
    assert stores[0].agg_frames_tracks_scores() == stores[1].agg_frames_tracks_scores()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two MUSDB-shaped tracks of 25,000 int16 samples (MUSDB18-HQ's PCM
    format) and a mel-12 model directory from the port's seeded init."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(42)
    for name in ["s1", "s2"]:
        d = root / "musdb" / "test" / name
        d.mkdir(parents=True)
        stems = {s: (rng.standard_normal((25000, 2)) * 3000).astype(np.int16) for s in Separator.sources}
        mix = sum(s.astype(np.int32) for s in stems.values()).clip(-32768, 32767).astype(np.int16)
        wavfile.write(d / "mixture.wav", 44100, mix)
        for s, a in stems.items():
            wavfile.write(d / f"{s}.wav", 44100, a)
    md = root / "model"
    md.mkdir()
    (md / "xumx_slicq_v2.json").write_text(json.dumps({"args": TINY_ARGS}))
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)
    torch.save(to_reference_state_dict(Unmix(shapes, seed=3, device=DEVICE)), md / "xumx_slicq_v2.pth")
    return root


def _run(tree, *extra):
    out = tree / f"scores{'_'.join(extra)}.json"
    store = E.evaluation_main(["--musdb-root", str(tree / "musdb"), "--model-path", str(tree / "model"),
                               "--device", "cpu", "--chunk-size", CHUNK, "--output-json", str(out), *extra])
    return store, out


def test_evaluation_modes_agree_and_match_jax_scorer(tree):
    host, host_json = _run(tree)
    assert [t.name for t in host.tracks] == ["s1", "s2"]
    agg = host.agg_frames_tracks_scores()
    for extra in (["--bss-on-device"], ["--device-resident", "--devices", "4"]):
        store, _ = _run(tree, *extra)
        other = store.agg_frames_tracks_scores()
        for t in agg:
            assert abs(agg[t]["SDR"] - other[t]["SDR"]) < SDR_MODES_DB, (extra, t)

    # the JAX float64 host engine on the port's own stems of the first track
    sep = Separator.load(model_path=tree / "model", device=DEVICE, chunk_size=int(CHUNK))
    for ts, td in zip(host.tracks[:1], E.list_tracks(str(tree / "musdb"), "test")):
        refs, ests = E.separate_track(sep, td)
        ref = jbss.eval_track(refs, ests, track_name=td.name, use_jax=False)
        for t in Separator.sources:
            for m in jbss.METRICS:
                np.testing.assert_allclose(ts.targets[t][m], ref.targets[t][m], rtol=0, atol=HOST_ATOL_DB)

    # shards: the port's JSON read by both packages, the JAX package's by the port
    jax_shard = tree / "jax_shard.json"
    jax_shard.write_text(json.dumps([jeval.track_scores_to_json(t) for t in host.tracks]))
    for store in (E.merge_results([host_json]), jeval.merge_results([host_json]), E.merge_results([jax_shard])):
        assert store.agg_frames_tracks_scores() == agg


def test_separate_track_device_matches_host_path(tree):
    """int16 staged and scaled on the device, forward_device: the same
    stems and references as the host path, bit for bit on the CPU."""
    sep = Separator.load(model_path=tree / "model", device=DEVICE, chunk_size=int(CHUNK))
    td = E.list_tracks(str(tree / "musdb"), "test")[0]
    refs_h, ests_h = E.separate_track(sep, td)
    refs_d, ests_d = E.separate_track_device(sep, td)
    for t in Separator.sources:
        assert refs_d[t].dtype == torch.int16
        np.testing.assert_array_equal(E.apply_pcm_scale(refs_d[t]).numpy(), refs_h[t])
        np.testing.assert_array_equal(ests_d[t].numpy(), ests_h[t])
    with pytest.raises(ValueError, match="single-track"):
        sep.forward_device(torch.zeros((2, 2, 100)))


def test_evaluation_needs_explicit_cpu(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        E.evaluation_main(["--musdb-root", str(tree / "musdb"), "--model-path", str(tree / "model")])
