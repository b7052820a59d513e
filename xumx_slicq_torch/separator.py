"""Separator: the port's inference engine.

Port of xumx_slicq_tpu/separator.py. One chunk runs sliCQT analysis ->
Unmix (the CDAE with BatchNorm folded, or the LSTM with K5's packed
recurrent weights; embedded Wiener-EM or mix-phase) -> the 4 targets folded
into the batch -> one inverse sliCQT. Chunking keeps the JAX package's
contract: the default chunk is 2,621,440 samples (~59.4 s), the last chunk
is zero-padded to the full chunk size, a single track of 2..8 chunks runs as
one chunk batch padded to 1, 2, 4 or 8, and anything else runs chunk by
chunk with the results left on the device until the end. For the CDAE the
padding is exact (slicing, the CDAE, eval BatchNorm and the Wiener-EM
statistics are invariant to appended zero slices and zero chunks). For the
LSTM it is not: its literal reshapes (models/lstm.py) mix the chunks of a
chunk batch, zero chunks included, into each sequence, so its stems depend
on this batching, and the port keeps it exactly as the JAX package does.

Model directories hold a JSON manifest (`xumx_slicq_tpu.json` or the
reference's `xumx_slicq_v2.json`) and weights as a reference-named torch
state dict (`xumx_slicq_tpu.pth` or `xumx_slicq_v2.pth`). The JAX package's
native `params.msgpack` needs flax to read and is not supported here.
"""

import copy
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .device import resolve_device
from .models import Unmix
from .models.convert import load_reference_state_dict
from .ops.slicqt import SliCQT

MANIFEST_NAMES = ("xumx_slicq_tpu.json", "xumx_slicq_v2.json")
WEIGHT_NAMES = ("xumx_slicq_tpu.pth", "xumx_slicq_v2.pth")


def load_manifest(model_path: Path) -> dict:
    for name in MANIFEST_NAMES:
        p = Path(model_path) / name
        if p.exists():
            with open(p) as f:
                return json.load(f)
    raise FileNotFoundError(f"no manifest ({'/'.join(MANIFEST_NAMES)}) in {model_path}")


class Separator:
    """Demix stereo mixtures into 4 stems, in the reference's target order
    (separator.py:48): bass, vocals, other, drums."""

    sources = ["bass", "vocals", "other", "drums"]
    _CHUNK_BATCH_BUCKETS = (1, 2, 4, 8)

    def __init__(
        self,
        slicqt: SliCQT,
        model: Unmix,
        sample_rate: float = 44100.0,
        chunk_size: Optional[int] = 2621440,
        device="cuda",
        quiet: bool = True,
    ):
        self.device = resolve_device(device)
        if slicqt.device != self.device:
            raise ValueError(f"SliCQT lives on {slicqt.device}, Separator on {self.device}")
        self.slicqt = slicqt
        self.model = model.to(self.device).eval()
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size if chunk_size is not None else sys.maxsize
        self.quiet = quiet
        # inference is eval-only: the CDAE's BatchNorm is folded into the conv
        # weights (cdae.fold_cdae_batchnorm), the LSTM's recurrent weights are
        # packed for K5, once here and not on every chunk
        self._prepared = model.inference_weights()

    # -- chunk pipeline ------------------------------------------------------

    def _chunk_fn(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, C, L) on the device -> (4, B, C, L) estimates on the device.
        Its three stages are `record_function` ranges, which a profile
        (utils.profile_stats) attributes device time to."""
        chunk_len = audio.shape[-1]
        with record_function("slicqt_forward"):
            X = self.slicqt.forward(audio)                   # list[(B,C,F,S,M)]
        with record_function("mask_model_and_wiener"):
            Y, _ = self.model.apply(X, self._prepared)
        with record_function("slicqt_backward"):
            # targets folded into the batch for one inverse transform
            est = self.slicqt.backward([y.reshape((-1,) + y.shape[2:]) for y in Y], chunk_len)
        return est.reshape(4, -1, est.shape[1], chunk_len)

    # -- public API ----------------------------------------------------------

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        return self.forward(audio)

    @torch.inference_mode()
    def forward(self, audio_big: np.ndarray) -> np.ndarray:
        """audio_big: (B, C, N) -> stacked estimates (4, B, C, N)."""
        audio_big = np.asarray(audio_big, np.float32)
        B, C, N = audio_big.shape
        chunk = min(self.chunk_size, max(N, self.slicqt.sllen // 2 + 1))
        nchunks = -(-N // chunk)

        if B == 1 and 1 < nchunks <= self._CHUNK_BATCH_BUCKETS[-1]:
            # one track: all chunks in one call, batch padded to a bucket
            nb = next(b for b in self._CHUNK_BATCH_BUCKETS if b >= nchunks)
            flat = self._host_buffer((nb, C, chunk), zero=True)
            for ci in range(nchunks):
                lo = ci * chunk
                hi = min(lo + chunk, N)
                flat.numpy()[ci, :, : hi - lo] = audio_big[0, :, lo:hi]
            est = self._chunk_fn(flat.to(self.device, non_blocking=True))  # (4, nb, C, chunk)
            est = est[:, :nchunks].transpose(1, 2).reshape(4, 1, C, nchunks * chunk)
            return self._to_host(est[..., :N])

        # chunk by chunk: launches queue up on the device and the results
        # stay there until the last chunk is in flight
        pend = []
        for ci in range(nchunks):
            lo = ci * chunk
            hi = min(lo + chunk, N)
            a = self._host_buffer((B, C, chunk), zero=True)
            a.numpy()[..., : hi - lo] = audio_big[..., lo:hi]
            pend.append(self._chunk_fn(a.to(self.device, non_blocking=True))[..., : hi - lo])
        return self._to_host(torch.cat(pend, dim=-1))

    @torch.inference_mode()
    def forward_device(self, audio: torch.Tensor) -> torch.Tensor:
        """Single-track forward on the device (xumx_slicq_tpu/separator.py:
        260-289): (1, C, N) audio on (or staged to) this Separator's device
        -> (4, 1, C, N) estimates that stay there, for scoring in place
        (ops/bsseval.DeviceBssEval). The chunking and chunk-batch buckets
        are `forward`'s, with the padding and reassembly done on the
        device."""
        audio = audio.to(self.device)
        B, C, N = audio.shape
        if B != 1:
            raise ValueError("forward_device is single-track (B == 1)")
        chunk = min(self.chunk_size, max(N, self.slicqt.sllen // 2 + 1))
        nchunks = -(-N // chunk)
        flat = torch.nn.functional.pad(audio[0].to(torch.float32), (0, nchunks * chunk - N))
        flat = flat.reshape(C, nchunks, chunk).transpose(0, 1)             # (nchunks, C, chunk)
        if 1 < nchunks <= self._CHUNK_BATCH_BUCKETS[-1]:
            nb = next(b for b in self._CHUNK_BATCH_BUCKETS if b >= nchunks)
            est = self._chunk_fn(torch.nn.functional.pad(flat, (0, 0, 0, 0, 0, nb - nchunks)))
            est = est[:, :nchunks]                                         # (4, nchunks, C, chunk)
        else:
            est = torch.cat([self._chunk_fn(flat[ci: ci + 1].contiguous()) for ci in range(nchunks)], dim=1)
        est = est.transpose(1, 2).reshape(4, C, nchunks * chunk)[..., :N]
        return est[:, None]                                                # (4, 1, C, N)

    def clone(self, device) -> "Separator":
        """A Separator on another device with the same transform geometry
        and a copy of the weights (one per card for the evaluator's
        `--devices`)."""
        dev = resolve_device(device)
        t = self.slicqt
        slicqt = SliCQT(scale=t.scale_name, fbins=t.fbins, fmin=t.fmin, fmax=t.fmax, fgamma=t.fgamma,
                        fs=t.fs, sllen=t.sllen, trlen=t.trlen, min_win=t.min_win, device=dev)
        model = copy.deepcopy(self.model).to(dev)
        return Separator(slicqt, model, sample_rate=self.sample_rate, chunk_size=self.chunk_size,
                         device=dev, quiet=self.quiet)

    def _host_buffer(self, shape, zero: bool = False) -> torch.Tensor:
        """Host staging buffer, page-locked when the device is a card: a
        copy from pageable memory runs at a fraction of the link's rate
        (a 236 s track's stems took 152 ms to copy back pageable on an
        H100 host). PyTorch caches page-locked blocks across calls."""
        pin = self.device.type == "cuda"
        if zero:
            return torch.zeros(shape, dtype=torch.float32, pin_memory=pin)
        return torch.empty(shape, dtype=torch.float32, pin_memory=pin)

    def _to_host(self, est: torch.Tensor) -> np.ndarray:
        if est.device.type == "cpu":
            return est.numpy()
        host = self._host_buffer(tuple(est.shape))
        host.copy_(est)                                  # synchronous: waits for the chunk program
        return host.numpy()

    def warmup(self, reps: int = 1, duration_s: float = 100.0):
        """Run on random audio (reference separator.py:83-91): the first
        run pays for cuFFT plans, cuDNN algorithm choice and kernel builds."""
        rng = np.random.default_rng(0)
        for r in range(reps):
            t0 = time.time()
            self.forward(rng.random((1, 2, int(duration_s * self.sample_rate)), np.float32))
            if not self.quiet:
                print(f"warmup {r + 1}/{reps}: {time.time() - t0:.1f}s", file=sys.stderr)

    @staticmethod
    def to_dict(estimates: np.ndarray, aggregate_dict: Optional[dict] = None) -> dict:
        """Stacked (4, B, C, N) -> {target: (B, C, N)} (separator.py:234-259)."""
        d = {t: estimates[k] for k, t in enumerate(Separator.sources)}
        if aggregate_dict is not None:
            d = {key: sum(d[t] for t in targets) for key, targets in aggregate_dict.items()}
        return d

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(
        cls,
        chunk_size: Optional[int] = 2621440,
        model_path: Optional[str] = None,
        device="cuda",
        warmup: int = 0,
        realtime: bool = False,
        quiet: bool = True,
    ) -> "Separator":
        """Build a Separator from a model directory (manifest + .pth)."""
        device = resolve_device(device)
        if model_path is None:
            raise ValueError("model_path is required (no bundled pretrained weights in this build)")
        model_path = Path(model_path).expanduser()
        args = load_manifest(model_path)["args"]

        slicqt = SliCQT(
            scale=args["fscale"], fbins=args["fbins"], fmin=args["fmin"],
            fgamma=args.get("fgamma", 0.0), fs=args.get("sample_rate", 44100.0),
            device=device,
        )
        shapes = slicqt.block_shapes(1, args.get("nb_channels", 2), int(args.get("seq_dur", 2.0) * slicqt.fs))
        if "realtime" in args and bool(args["realtime"]) != bool(realtime) and realtime:
            # the manifest records which variant the weights were trained as
            print(
                f"warning: --realtime={realtime} ignored; manifest at {model_path} "
                f"declares realtime={args['realtime']} (weights define the variant)",
                file=sys.stderr,
            )
        model = Unmix(
            shapes, realtime=args.get("realtime", realtime), lstm=args.get("lstm", False),
            hidden_size_1=args.get("hidden_size_1", 50),
            hidden_size_2=args.get("hidden_size_2", 51),
            time_filter_2=args.get("time_filter_2", 4),
            device=device,
        )
        model.load_state_dict(load_model_weights(model_path))
        sep = cls(slicqt, model, sample_rate=args.get("sample_rate", 44100.0),
                  chunk_size=chunk_size, device=device, quiet=quiet)
        if warmup > 0:
            sep.warmup(warmup)
        return sep


def load_model_weights(model_path: Path) -> dict:
    """The port's state_dict from a reference-named .pth in model_path."""
    for name in WEIGHT_NAMES:
        pth = Path(model_path) / name
        if pth.exists():
            return load_reference_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    if (Path(model_path) / "params.msgpack").exists():
        raise FileNotFoundError(
            f"{model_path} holds only params.msgpack, which needs flax to read; "
            f"save the weights as {WEIGHT_NAMES[0]} (models.convert.to_reference_state_dict)"
        )
    raise FileNotFoundError(f"no weights ({'/'.join(WEIGHT_NAMES)}) found in {model_path}")
