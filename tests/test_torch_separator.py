"""The port end to end: Separator against the JAX package's, the CLI, and
import isolation.

A mel-12 model directory whose weights the port wrote
(to_reference_state_dict -> xumx_slicq_v2.pth) is loaded by both packages'
Separator.load; multi-chunk input goes through both. The stems must agree
within 1e-5 absolute on 0.1-RMS input (measured ~1e-7): tighter than the
3e-4 the JAX package holds itself to against the torch original
(README.md:97-99), since here both sides run the same algorithm in fp32.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, MEL12, TINY_ARGS, TINY_LEN, noise, one_thread_env

from xumx_slicq_tpu.separator import Separator as JaxSeparator
from xumx_slicq_torch import audio
from xumx_slicq_torch.inference import inference_main
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models.convert import to_reference_state_dict
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator

ROOT = Path(__file__).resolve().parent.parent
STEM_ATOL = 1e-5
CHUNK = 16384


def _model_dir(d: Path, realtime: bool) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    (d / "xumx_slicq_v2.json").write_text(json.dumps({"args": dict(TINY_ARGS, realtime=realtime)}))
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)
    model = Unmix(shapes, realtime=realtime, seed=3, device=DEVICE)
    torch.save(to_reference_state_dict(model), d / "xumx_slicq_v2.pth")
    return d


@pytest.fixture(scope="module")
def offline_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory.mktemp("offline"), realtime=False)


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_separator_matches_jax(tmp_path, offline_dir, realtime):
    """3 chunks with a short last one: one chunk batch padded to 4."""
    d = offline_dir if not realtime else _model_dir(tmp_path / "rt", realtime=True)
    ours = Separator.load(model_path=d, device=DEVICE, chunk_size=CHUNK)
    ref = JaxSeparator.load(model_path=d, runtime_backend="jax-cpu", chunk_size=CHUNK)
    assert ours.model.realtime is realtime
    x = noise(7, (1, 2, 2 * CHUNK + 3000), 0.1)
    a, b = ours(x), np.asarray(ref(x))
    assert a.shape == b.shape == (4, 1, 2, x.shape[-1])
    np.testing.assert_allclose(a, b, rtol=0, atol=STEM_ATOL)
    assert list(Separator.to_dict(a)) == ["bass", "vocals", "other", "drums"]


def test_separator_batched_and_short_inputs_match_jax(offline_dir):
    """B = 2 runs chunk by chunk; a one-chunk input pads to sllen/2 + 1."""
    ours = Separator.load(model_path=offline_dir, device=DEVICE, chunk_size=CHUNK)
    ref = JaxSeparator.load(model_path=offline_dir, runtime_backend="jax-cpu", chunk_size=CHUNK)
    x = noise(8, (2, 2, CHUNK + 500), 0.1)
    np.testing.assert_allclose(ours(x), np.asarray(ref(x)), rtol=0, atol=STEM_ATOL)
    short = np.zeros((1, 2, 100), np.float32)
    assert ours(short).shape == (4, 1, 2, 100)
    d = Separator.to_dict(ours(x), {"vocals": ["vocals"], "accomp": ["bass", "other", "drums"]})
    full = Separator.to_dict(ours(x))
    np.testing.assert_allclose(d["accomp"], full["bass"] + full["other"] + full["drums"], atol=1e-6)


BARK262_ATOL = 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("lstm", [False, True], ids=["cdae", "lstm"])
def test_separator_matches_jax_at_bark262(tmp_path, lstm):
    """The canonical geometry (bark-262, 70 buckets): both packages'
    Separator.load on one directory (the port's params.msgpack, weights
    from seed 0), demixing the mix of 2 s of seeded stems (0.1 RMS each),
    within 1e-4 absolute. Compiles the JAX program at full width (slow)."""
    from xumx_slicq_torch.separator import save_model_weights

    args = dict(fscale="bark", fbins=262, fmin=32.9, sample_rate=44100.0, seq_dur=2.0, nb_channels=2,
                realtime=False, lstm=lstm)
    (tmp_path / "xumx_slicq_v2.json").write_text(json.dumps({"args": args}))
    shapes = SliCQT(device=DEVICE).block_shapes(1, 2, 2 * 44100)
    save_model_weights(tmp_path, Unmix(shapes, lstm=lstm, seed=0, device=DEVICE))
    ours = Separator.load(model_path=tmp_path, device=DEVICE)
    ref = JaxSeparator.load(model_path=tmp_path, runtime_backend="jax-cpu")
    x = noise(21, (1, 4, 2, 2 * 44100), 0.1).sum(1)
    a, b = ours(x), np.asarray(ref(x))
    assert a.shape == b.shape == (4, 1, 2, x.shape[-1]) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=BARK262_ATOL)


def test_separator_needs_explicit_cpu(offline_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Separator.load(model_path=offline_dir)


def test_inference_cli(offline_dir, tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    audio.save_audio(indir / "song.wav", noise(2, (2, 22050), 0.1), 44100)
    inference_main(["--input-dir", str(indir), "--output-dir", str(outdir),
                    "--model-path", str(offline_dir), "--device", "cpu", "--chunk-size", str(CHUNK)])
    for stem in Separator.sources:
        a, sr = audio.load_audio(outdir / "song" / f"{stem}.wav")
        assert sr == 44100 and a.shape == (2, 22050) and np.isfinite(a).all()


_ISOLATION = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import xumx_slicq_torch
skipped = []
for m in pkgutil.walk_packages(xumx_slicq_torch.__path__, "xumx_slicq_torch."):
    try:
        importlib.import_module(m.name)
    except ModuleNotFoundError as e:
        if e.name != "triton":
            raise
        skipped.append(m.name)
import chip_smoke
import bench_torch
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "yaml", "xumx_slicq_tpu", "cadenza"))
print(json.dumps({"skipped": skipped, "bad": bad,
                  "ported": sorted(k for k in sys.modules if k.startswith("xumx_slicq_torch"))}))
"""


def test_port_never_imports_jax():
    """Every port module (the trainer's, the LSTM's, the evaluator's, the
    tools', the mesh's and the Cadenza runner's among them), chip_smoke.py
    and bench_torch.py import without jax, flax, msgpack, yaml, the JAX
    package or cadenza; only the Triton module needs triton (absent here)."""
    res = subprocess.run([sys.executable, "-c", _ISOLATION, str(ROOT)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=one_thread_env())
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert len(out["ported"]) >= 46
    assert {f"xumx_slicq_torch.{m}" for m in ("data", "loss", "training", "models.lstm",
                                              "kernels.lstm_recurrence", "evaluation",
                                              "ops.bsseval", "export", "slicqfinder", "tuning",
                                              "visualization", "demixui", "ops.wiener_contrib",
                                              "utils.runtime", "utils.profile_stats",
                                              "kernels.ops", "parallel.mesh", "entry", "cadenza.enhance",
                                              "cadenza.haaqi", "cadenza.config", "models.flax_msgpack")} \
        <= set(out["ported"])
    try:
        import triton  # noqa: F401
        assert out["skipped"] == []
    except ModuleNotFoundError:
        assert out["skipped"] == ["xumx_slicq_torch.kernels.triton_wiener_em"]
