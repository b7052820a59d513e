"""The port's Cadenza runner (xumx_slicq_torch/cadenza/) against cadenza/.

The NumPy/SciPy parts are copies: on seeded inputs each function gives
bit-equal results to cadenza/'s. The config loads with PyYAML blocked. The
recipe runs end to end (enhance -> evaluate -> merge) with a port mel-12
model on the CPU, as tests/test_cadenza.py's end-to-end test does with the
JAX package's.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_port_utils import one_thread_env, port_model_dir

import cadenza.haaqi as jax_haaqi
import cadenza.signal_processing as jax_sp
from xumx_slicq_torch import audio
from xumx_slicq_torch.cadenza import haaqi, signal_processing as sp

ROOT = Path(__file__).resolve().parent.parent
MODERATE = [20, 20, 30, 40, 50, 55]
CFS = [250, 500, 1000, 2000, 4000, 6000]


def _sig(seed, n=24000):
    return np.random.default_rng(seed).standard_normal(n) * 0.1


def _nalr(m):
    nalr = m.NALR(nfir=220, fs=44100)
    fir, delay = nalr.build(np.asarray(MODERATE, float), np.asarray(CFS, float))
    return fir, delay, nalr.apply(fir, _sig(1, 8000))


def _compressor(m):
    t = np.arange(32000) / 16000
    x = np.sin(2 * np.pi * 440 * t) * np.where(t > 1.0, 4.0, 1.0)
    return m.Compressor(fs=16000, threshold=0.35, attenuation=0.1, attack=50, release=1000,
                        rms_buffer_size=0.064).process(x)


CASES = {
    "nalr": lambda m, h: _nalr(m),
    "compressor": lambda m, h: _compressor(m),
    "clip_signal": lambda m, h: (m.clip_signal(_sig(2) * 20, False), m.clip_signal(_sig(2) * 20, True)),
    "to_16bit": lambda m, h: m.to_16bit(_sig(3) * 12),
    "resample": lambda m, h: (m.resample(_sig(4, 4410), 44100, 24000), m.resample(_sig(5, 4800), 24000, 32000)),
    "haaqi_v1": lambda m, h: h.haaqi_v1(_sig(6), 24000, _sig(6) + 0.3 * _sig(7), 24000, MODERATE),
    "compute_haaqi": lambda m, h: h.compute_haaqi(_sig(8), _sig(8) * 0.9 + 0.1 * _sig(9), 24000, 24000,
                                                  MODERATE, CFS),
}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [np.asarray(x)]


@pytest.mark.parametrize("case", list(CASES))
def test_numpy_parts_bit_equal_to_cadenza(case):
    ours = _flat(CASES[case](sp, haaqi))
    ref = _flat(CASES[case](jax_sp, jax_haaqi))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_config_loads_without_yaml():
    """config.yaml's defaults and a user override file, with yaml blocked
    from import (the card's machine has no PyYAML)."""
    code = r"""
import builtins, json, sys
sys.path.insert(0, sys.argv[1])
real = builtins.__import__
def block(name, *a, **k):
    if name.split(".")[0] == "yaml":
        raise ModuleNotFoundError("No module named 'yaml'", name="yaml")
    return real(name, *a, **k)
builtins.__import__ = block
from xumx_slicq_torch.cadenza.config import load_config
cfg = load_config()
cfg2 = load_config(sys.argv[2])
print(json.dumps({"sr": cfg.sample_rate, "nfir": cfg.nalr.nfir, "meta": cfg.path.metadata_dir,
                  "device": cfg.separator.device, "model_path": cfg.separator.model_path,
                  "sr2": cfg2.sample_rate, "nfir2": cfg2.nalr.nfir, "thr2": cfg2.compressor.threshold,
                  "yaml": "yaml" in sys.modules}))
"""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        y = Path(d) / "override.yaml"
        y.write_text("# user settings\nsample_rate: 22050   # Hz\nnalr:\n  nfir: 100\n")
        res = subprocess.run([sys.executable, "-c", code, str(ROOT), str(y)], capture_output=True, text=True,
                             timeout=60, env=one_thread_env())
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"sr": 44100, "nfir": 220, "meta": "/CADENZA/cad1/task1/metadata", "device": "cuda",
                   "model_path": None, "sr2": 22050, "nfir2": 100, "thr2": 0.35, "yaml": False}


def test_config_matches_pyyaml():
    """parse_yaml reads both recipes' config.yaml as PyYAML does, and
    refuses what it does not parse."""
    import yaml

    from xumx_slicq_torch.cadenza.config import parse_yaml

    for path in (ROOT / "cadenza" / "config.yaml", ROOT / "xumx_slicq_torch" / "cadenza" / "config.yaml"):
        assert parse_yaml(path.read_text()) == yaml.safe_load(path.read_text())
    with pytest.raises(ValueError):
        parse_yaml("a:\n  - 1\n")


def test_enhance_evaluate_merge_end_to_end(tmp_path):
    """tests/test_cadenza.py:178-end with the port: a fabricated 1-song,
    1-listener dataset and a port mel-12 model on the CPU."""
    from xumx_slicq_torch.cadenza.config import load_config
    from xumx_slicq_torch.cadenza.enhance import enhance
    from xumx_slicq_torch.cadenza.evaluate import evaluate
    from xumx_slicq_torch.cadenza.merge_batches_results import merge

    song = "Test Song - Demo"
    d = tmp_path / "musdb" / "train" / song
    d.mkdir(parents=True)
    n = 2 * 44100
    t = np.arange(n) / 44100
    stems = {}
    for i, s in enumerate(("bass", "drums", "other", "vocals")):
        f0 = [80, 300, 1000, 2000][i]
        stems[s] = (0.1 * np.stack([np.sin(2 * np.pi * f0 * t), np.sin(2 * np.pi * f0 * 1.01 * t)])).astype(np.float32)
    audio.save_audio(d / "mixture.wav", sum(stems.values()), 44100)
    for s, a in stems.items():
        audio.save_audio(d / f"{s}.wav", a, 44100)

    meta = tmp_path / "metadata"
    meta.mkdir()
    (meta / "musdb18.valid.json").write_text(json.dumps([{"Track Name": song, "Split": "train"}]))
    listeners = {"L001": {"name": "L001", "audiogram_cfs": CFS, "audiogram_levels_l": MODERATE,
                          "audiogram_levels_r": MODERATE}}
    (meta / "listeners.valid.json").write_text(json.dumps(listeners))

    md = port_model_dir(tmp_path / "model")
    cfg = load_config(overrides={
        "path": {
            "music_dir": str(tmp_path / "musdb"),
            "metadata_dir": str(meta),
            "music_valid_file": str(meta / "musdb18.valid.json"),
            "listeners_valid_file": str(meta / "listeners.valid.json"),
            "exp_folder": str(tmp_path / "exp"),
        },
        "separator": {"model_path": str(md), "device": "cpu"},
    })

    enhance(cfg)
    enhanced = tmp_path / "exp" / "enhanced_signals" / "L001" / song
    assert len(list(enhanced.glob("*.wav"))) == 9  # 8 stems + remix
    assert (enhanced / f"L001_{song}_remix.wav").exists()
    for side in ("left", "right"):
        for src in ("bass", "vocals", "other", "drums"):     # the Separator's stem order
            assert (enhanced / f"L001_{song}_{side}_{src}.wav").exists()

    evaluate(cfg)
    merged = merge(str(tmp_path / "exp"))
    text = merged.read_text().splitlines()
    assert len(text) == 2  # header + one row
    assert 0.0 <= float(text[1].split(",")[2]) <= 1.0
