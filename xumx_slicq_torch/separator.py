"""Separator: the port's inference engine.

Port of xumx_slicq_tpu/separator.py. One chunk runs sliCQT analysis ->
Unmix (the CDAE with BatchNorm folded, or the LSTM with K5's packed
recurrent weights; embedded Wiener-EM or mix-phase) -> the 4 targets folded
into the batch -> one inverse sliCQT. Chunking keeps the JAX package's
contract on every path. The default chunk is 2,621,440 samples (~59.4 s),
and the last chunk is zero-padded to the full chunk size. `forward` on one
device runs a single track of 2..8 chunks as one chunk batch padded to 1,
2, 4 or 8, and anything else chunk by chunk with the results left on the
device until the end (JAX separator.py:206-258). `forward_device`, and
every call over several devices, runs a track in waves (JAX
`_wave_dispatch`, separator.py:164-185): at most 8 x n_dev chunks a wave,
one chunk batch of b x n_dev chunks, b the smallest of 1, 2, 4, 8 that
holds the wave, zero chunks padding it. For the CDAE the padding is exact
(slicing, the CDAE, eval BatchNorm and the Wiener-EM statistics are
invariant to appended zero slices and zero chunks). For the LSTM it is not:
its literal reshapes (models/lstm.py) mix the chunks of a chunk batch, zero
chunks included, into each sequence, so its stems depend on this batching,
and the port forms the JAX package's chunk batches exactly.

Several devices (`devices=[...]`, the counterpart of the JAX package's
`mesh=`): a replica of the model on each, replica d taking chunks
d b .. (d + 1) b - 1 of a wave's batch. A device may be listed twice. The
CDAE runs each replica's chunks on their own. An LSTM model's masks are
the wave's whole batch's, as the JAX mesh's sharded program computes them,
so the first replica runs each LSTM wave as one `_chunk_fn` on the wave's
b x n_dev chunks (zero chunks too: a one-chunk track is padded to n_dev
chunks, as the JAX mesh pads it). So the stems of either model are those
of the one-device `_chunk_fn` on the wave's chunk batch. The LSTM's other
replicas stay idle: at n_dev = 4 a wave of up to 32 chunks runs on the
first card (its time and peak memory: chip_smoke.py's
separator_devices_lstm).

Model directories hold a JSON manifest (`xumx_slicq_tpu.json` or the
reference's `xumx_slicq_v2.json`) and weights: the JAX package's native
`params.msgpack` (read and written in plain Python, models/flax_msgpack.py),
else a reference-named torch state dict (`xumx_slicq_tpu.pth` or
`xumx_slicq_v2.pth`), in the JAX package's order (separator.py:405-423).
"""

import contextlib
import copy
import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .device import resolve_device, same_device
from .models import Unmix
from .models.convert import PARAMS_FILE, load_params_msgpack, load_reference_state_dict, params_msgpack_bytes
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
        device=None,
        quiet: bool = True,
        devices: Optional[Sequence] = None,
    ):
        """device: the card ("cuda" when neither it nor `devices` is given)
        or "cpu". devices: several devices (exclusive with `device`); the
        slicqt and model are the first's and copied to the others."""
        if devices is not None and device is not None:
            raise ValueError("pass either device or devices, not both")
        if devices is not None and len(devices) == 0:
            raise ValueError("devices is empty")
        self.device = resolve_device(devices[0] if devices is not None else device or "cuda")
        if not same_device(slicqt.device, self.device):
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
        # one Separator a device; this one is the first
        self.replicas: List["Separator"] = [self] + [self.clone(d) for d in (devices or [])[1:]]

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

        if len(self.replicas) > 1:
            # each item over the devices in turn (JAX separator.py:205-230); one item's stems are not copied again
            outs = [self._forward_waves(audio_big[b: b + 1], chunk, nchunks) for b in range(B)]
            return outs[0] if B == 1 else np.concatenate(outs, axis=1)

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

    def _waves(self, chunk: int, nchunks: int, stage) -> torch.Tensor:
        """A track's chunks over the devices in full waves (JAX
        separator.py:164-185): at most 8 x n_dev chunks a wave, each device
        taking a chunk batch b from the buckets, the smallest with
        b n_dev >= the wave's chunks, zero chunks padding the last.
        stage(ci, nb, device) gives the (nb, C, chunk) block of chunks
        ci.. on `device`. Every launch is queued before any result is
        gathered. Returns the (4, nchunks, C, chunk) estimates on the
        first device."""
        n_dev = len(self.replicas)
        cap = self._CHUNK_BATCH_BUCKETS[-1] * n_dev
        parts = []
        ci = 0
        while ci < nchunks:
            take = min(nchunks - ci, cap)
            nb = next(b for b in self._CHUNK_BATCH_BUCKETS if b * n_dev >= take)
            if self.model.lstm and n_dev > 1:
                # the LSTM's sequences run through the wave's whole chunk batch (module docstring): one call
                jobs = [(self, ci, nb * n_dev)]
            else:
                jobs = [(replica, ci + d * nb, nb) for d, replica in enumerate(self.replicas) if d * nb < take]
            for replica, lo, size in jobs:
                # the replica's card current while it launches: the hand-written kernels launch on the current one
                card = torch.cuda.device(replica.device) if replica.device.type == "cuda" else contextlib.nullcontext()
                with card, torch.inference_mode():
                    parts.append((min(size, ci + take - lo), replica._chunk_fn(stage(lo, size, replica.device))))
            ci += take
        return torch.cat([est[:, :n].to(self.device) for n, est in parts], dim=1)

    def _forward_waves(self, audio: np.ndarray, chunk: int, nchunks: int) -> np.ndarray:
        """One track (1, C, N) over the devices -> (4, 1, C, N) on the host."""
        _, C, N = audio.shape

        def stage(lo, nb, device):
            flat = self._host_buffer((nb, C, chunk), zero=True)
            for k in range(nb):
                a, b = (lo + k) * chunk, min((lo + k + 1) * chunk, N)
                if a < N:
                    flat.numpy()[k, :, : b - a] = audio[0, :, a:b]
            return flat.to(device, non_blocking=True)

        # reassembled on the first device, as the single-device path does, then one copy back
        est = self._waves(chunk, nchunks, stage)
        return self._to_host(est.transpose(1, 2).reshape(4, 1, C, nchunks * chunk)[..., :N])

    @torch.inference_mode()
    def forward_device(self, audio: torch.Tensor) -> torch.Tensor:
        """Single-track forward on the device (xumx_slicq_tpu/separator.py:
        260-289): (1, C, N) audio on (or staged to) this Separator's device
        -> (4, 1, C, N) estimates that stay there, for scoring in place
        (ops/bsseval.DeviceBssEval). The chunks run in the JAX package's
        waves (`_waves`), on one device too, with the padding and
        reassembly done on the device."""
        audio = audio.to(self.device)
        B, C, N = audio.shape
        if B != 1:
            raise ValueError("forward_device is single-track (B == 1)")
        chunk = min(self.chunk_size, max(N, self.slicqt.sllen // 2 + 1))
        nchunks = -(-N // chunk)
        flat = torch.nn.functional.pad(audio[0].to(torch.float32), (0, nchunks * chunk - N))
        flat = flat.reshape(C, nchunks, chunk).transpose(0, 1)             # (nchunks, C, chunk)

        def stage(lo, nb, device):
            blk = flat[lo: lo + nb]
            return torch.nn.functional.pad(blk, (0, 0, 0, 0, 0, nb - len(blk))).contiguous().to(device)

        est = self._waves(chunk, nchunks, stage)                           # (4, nchunks, C, chunk)
        est = est.transpose(1, 2).reshape(4, C, nchunks * chunk)[..., :N]
        return est[:, None]                                                # (4, 1, C, N)

    def clone(self, device) -> "Separator":
        """A Separator on another device with the same transform geometry
        and a copy of the weights (one per card for the evaluator's
        `--devices`, one per device of `devices=`)."""
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
        device=None,
        warmup: int = 0,
        realtime: bool = False,
        quiet: bool = True,
        devices: Optional[Sequence] = None,
    ) -> "Separator":
        """Build a Separator from a model directory (manifest + weights) on
        `device` ("cuda" by default) or on several `devices` (exclusive)."""
        if devices is not None and device is not None:
            raise ValueError("pass either device or devices, not both")
        device = resolve_device(devices[0] if devices else device or "cuda")
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
        model.load_state_dict(load_model_weights(model_path, model))
        sep = cls(slicqt, model, sample_rate=args.get("sample_rate", 44100.0), chunk_size=chunk_size,
                  device=None if devices else device, quiet=quiet, devices=devices)
        if warmup > 0:
            sep.warmup(warmup)
        return sep


def load_model_weights(model_path: Path, model: Optional[Unmix] = None) -> dict:
    """The port's state_dict from model_path: the JAX package's
    `params.msgpack` first, then a reference-named .pth, in the JAX
    package's order (separator.py:405-423). `model`, when given, is checked
    against the msgpack's variant (CDAE or LSTM)."""
    native = Path(model_path) / PARAMS_FILE
    if native.exists():
        sd, lstm = load_params_msgpack(native)
        if model is not None and lstm != model.lstm:
            raise ValueError(f"{native} holds {'an LSTM' if lstm else 'a CDAE'} model, the manifest the other")
        return sd
    for name in WEIGHT_NAMES:
        pth = Path(model_path) / name
        if pth.exists():
            return load_reference_state_dict(torch.load(pth, map_location="cpu", weights_only=True))
    raise FileNotFoundError(f"no weights ({PARAMS_FILE} or {'/'.join(WEIGHT_NAMES)}) "
                            f"found in {model_path}")


def save_model_weights(model_path: Path, model: Unmix) -> Path:
    """Write the model's weights as the JAX package's `params.msgpack`
    (xumx_slicq_tpu/separator.py:426-432): both packages load it."""
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    out = model_path / PARAMS_FILE
    out.write_bytes(params_msgpack_bytes(model))
    return out
