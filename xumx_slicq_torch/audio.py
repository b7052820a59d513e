"""Wav I/O and input normalisation for the port (scipy only).

A copy of `load_info`, `load_audio`, `save_audio` and `preprocess_audio`
from xumx_slicq_tpu/data.py:51-221 with the PCM helpers they call (the
training datasets in data.py read through them too); the port imports
nothing of the JAX package.
"""

from math import gcd
from typing import Optional

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

# PCM full-scale factors; 1/2^k is exact in binary, so int -> float32
# followed by a float32 multiply matches the float64 route
_PCM_SCALE = {"int16": 1.0 / 32768.0, "int32": 1.0 / 2147483648.0}


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
        audio = resample_poly(audio, int(model_rate) // g, int(rate) // g, axis=-1).astype(np.float32)
    return audio
