"""Wav I/O and input normalisation for the port (scipy only).

A copy of `load_info`, `load_audio`, `load_audio_raw`, `save_audio` and
`preprocess_audio` from xumx_slicq_tpu/data.py:51-221 with the PCM helpers
they call (`pcm_scale_info`, `apply_pcm_scale`; the training datasets in
data.py read through them too); the port imports nothing of the JAX package.
"""

from math import gcd
from typing import Optional

import numpy as np
import torch
from scipy.io import wavfile

# PCM full-scale factors; 1/2^k is exact in binary, so int -> float32
# followed by a float32 multiply matches the float64 route
_PCM_SCALE = {"int16": 1.0 / 32768.0, "int32": 1.0 / 2147483648.0}


def pcm_scale_info(dtype) -> tuple:
    """(scale, offset) such that float = (raw - offset) * scale for a wav
    sample dtype (a numpy dtype or a torch dtype); raises on unsupported
    dtypes. The one rule shared by the host loader and the paths that stage
    raw PCM on the card and scale it there (ops/bsseval.py, evaluation.py)."""
    name = str(dtype).rsplit(".", 1)[-1] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name
    if name in ("float32", "float64"):
        return 1.0, 0.0
    if name in _PCM_SCALE:
        return _PCM_SCALE[name], 0.0
    if name == "uint8":
        return 1.0 / 128.0, 128.0
    raise ValueError(f"unsupported wav dtype {name}")


def apply_pcm_scale(x, src_dtype=None):
    """Raw PCM (or float) samples -> float by their wav full scale:
    (raw - offset) * scale. A numpy array gives float64 on the host (the
    float64 BSS-eval engine's input); a torch tensor gives float32 on the
    tensor's own device. The dtype is checked before any conversion; pass
    `src_dtype` when `x` was staged from an array of another dtype, so that
    the check and the scale come from the source."""
    scale, offset = pcm_scale_info(src_dtype if src_dtype is not None else x.dtype)
    if isinstance(x, torch.Tensor):
        a = x.to(torch.float32)
    else:
        a = np.asarray(x, np.float64)
    if offset:
        a = a - offset
    if scale != 1.0:
        a = a * scale
    return a


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    scale = _PCM_SCALE.get(data.dtype.name)
    if scale is not None:
        out = data.astype(np.float32)
        out *= np.float32(scale)
        return out
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported wav dtype {data.dtype}")


def _crop_to_float32(seg: np.ndarray, gain: float = 1.0, out: Optional[np.ndarray] = None) -> np.ndarray:
    """(samples, C) wav slice of any supported dtype -> (C, samples)
    float32 scaled by its PCM full-scale times `gain`, in one pass, into
    `out` or a new owned array."""
    scale = _PCM_SCALE.get(seg.dtype.name)
    if scale is None and seg.dtype not in (np.float32, np.float64):
        res = _to_float32(np.asarray(seg)).T                  # uint8 / raises
        if gain != 1.0:
            res = res * np.float32(gain)
        if out is None:
            return np.array(res, np.float32, order="C")
        out[...] = res
        return out
    if out is None:
        out = np.empty((seg.shape[1], seg.shape[0]), np.float32)
    np.multiply(seg.T, np.float32(gain * (scale if scale is not None else 1.0)), out=out)
    return out


def load_info(path: str) -> dict:
    """Audio metadata: samplerate, samples, channels, duration."""
    sr, data = wavfile.read(str(path), mmap=True)
    channels = 1 if data.ndim == 1 else data.shape[1]
    return {"samplerate": sr, "samples": data.shape[0], "channels": channels, "duration": data.shape[0] / sr}


def load_audio(path: str, start: float = 0.0, dur: Optional[float] = None):
    """Load a wav file -> ((channels, samples) float32, samplerate)."""
    sr, data = wavfile.read(str(path), mmap=True)
    if dur is not None:
        lo = int(start * sr)
        data = data[lo: lo + int(dur * sr)]
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    return _crop_to_float32(data), sr


def load_audio_raw(path: str):
    """Load a wav file without float conversion -> ((channels, samples) in
    the file's own dtype, samplerate). For PCM_16 sources (MUSDB18-HQ
    stems) int16 is the lossless staging format with half the bytes of
    float32: it goes to the card as it is and is scaled there."""
    sr, data = wavfile.read(str(path), mmap=True)
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    return data.T.copy(), sr


def save_audio(path: str, audio: np.ndarray, sample_rate: int):
    """Write (channels, samples) float32 as a 32-bit float wav (the
    reference writes PCM_F wavs, inference.py:129-138)."""
    wavfile.write(str(path), int(sample_rate), np.asarray(audio, np.float32).T)


def preprocess_audio(audio: np.ndarray, rate: Optional[float] = None, model_rate: Optional[float] = None) -> np.ndarray:
    """Normalise to (nb_samples, 2, nb_timesteps), resampling if needed
    (reference data.py:98-156)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, None, :]
    elif audio.ndim == 2:
        if min(audio.shape) <= 2:
            audio = audio[None, ...]
        else:
            audio = audio[:, None, :]
    if audio.shape[1] > audio.shape[2]:
        audio = np.swapaxes(audio, 1, 2)
    if audio.shape[1] > 2:
        audio = audio[:, :2]
    if audio.shape[1] == 1:
        audio = np.repeat(audio, 2, axis=1)
    if rate is not None and model_rate is not None and rate != model_rate:
        g = gcd(int(rate), int(model_rate))
        from scipy.signal import resample_poly      # here: scipy.signal takes seconds to import, a rank's start-up

        audio = resample_poly(audio, int(model_rate) // g, int(rate) // g, axis=-1).astype(np.float32)
    return audio
