"""Demixing whole tracks with the reference: the chunking and padding
rule of the measured Separator, then the transform, the mask model,
the post-filter (Wiener-EM, or the mixture's phase for the realtime
model) and the inverse transform.

The rule (xumx_slicq_v2's separator, as the measured package keeps it):
a chunk is `chunk_size` samples, or the track's whole length when shorter
(at least sllen/2 + 1). A track of 2 to 8 chunks runs as one chunk batch,
padded with zero chunks to 2, 4 or 8, the last chunk zero-padded to the
chunk size; the estimates are cut back to the track's length. Other tracks
run chunk by chunk. The Wiener-EM's stability scale and the LSTM's
sequences span the whole chunk batch, so the padding is part of the result.
"""

from typing import List, Sequence

import numpy as np
import torch

from . import models
from .slicqt import PlainSliCQT

BUCKETS = (1, 2, 4, 8)


def chunk_plan(n: int, chunk_size: int, sllen: int):
    """(chunk, nchunks, batches): batches is a list of (first chunk, chunks, padded batch)."""
    chunk = min(chunk_size, max(n, sllen // 2 + 1))
    nchunks = -(-n // chunk)
    if 1 < nchunks <= BUCKETS[-1]:
        return chunk, nchunks, [(0, nchunks, next(b for b in BUCKETS if b >= nchunks))]
    return chunk, nchunks, [(c, 1, 1) for c in range(nchunks)]


def stage(audio: np.ndarray, chunk: int, first: int, count: int, nb: int, device) -> torch.Tensor:
    """Chunks first..first+count-1 of a (C, N) track as a zero-padded (nb, C, chunk) batch."""
    C, N = audio.shape
    flat = np.zeros((nb, C, chunk), np.float32)
    for i in range(count):
        lo = (first + i) * chunk
        seg = audio[:, lo: min(lo + chunk, N)]
        flat[i, :, : seg.shape[-1]] = seg
    return torch.from_numpy(flat).to(device)


class Demixer:
    """The reference's whole demix of one configuration on one device."""

    def __init__(self, config: dict, weights: dict, device):
        t = config["transform"]
        self.config = config
        self.device = torch.device(device)
        self.slicqt = PlainSliCQT(t["scale"], t["fbins"], t["fmin"], t.get("fmax", 22050.0), t["fs"], device)
        self.w = weights

    def _masks(self, mags: Sequence[Sequence[torch.Tensor]]) -> List[List[torch.Tensor]]:
        if self.config["model"] == "lstm":
            return models.lstm_masks(self.w, mags)
        # The convs on PyTorch's own im2col and GEMM, not cuDNN: which
        # algorithm cuDNN runs is its choice, and its algorithms round
        # differently, so the reference's arithmetic would not be fixed.
        cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            return [[models.cdae_masks(self.w, k, m, self.config) for k, m in enumerate(ms)] for ms in mags]
        finally:
            torch.backends.cudnn.enabled = cudnn

    @torch.no_grad()
    def demix(self, tracks: Sequence[np.ndarray]) -> List[np.ndarray]:
        """(C, N) tracks -> (4, C, N) stems each. The tracks' chunk batches
        pass the mask model together (the LSTM's recurrence is walked once
        for all of them); each batch is otherwise its own."""
        jobs = []            # (track, chunk, first, count, nb)
        for ti, a in enumerate(tracks):
            chunk, _, batches = chunk_plan(a.shape[-1], self.config["chunk_size"], self.slicqt.sllen)
            jobs += [(ti, chunk, *b) for b in batches]
        X = [self.slicqt.forward(stage(tracks[ti], chunk, first, count, nb, self.device))
             for ti, chunk, first, count, nb in jobs]
        masks = self._masks([[torch.abs(x) for x in xs] for xs in X])
        parts = [[] for _ in tracks]
        for (ti, chunk, first, count, nb), xs, ms in zip(jobs, X, masks):
            Y = [models.post_filter(self.config, x, m * torch.abs(x)[None]) for x, m in zip(xs, ms)]
            est = torch.cat([self.slicqt.backward([y[t] for y in Y], chunk)[None] for t in range(4)])
            parts[ti].append(est[:, :count].transpose(1, 2).reshape(4, est.shape[2], count * chunk).cpu())
        out = []
        for ti, a in enumerate(tracks):
            out.append(torch.cat(parts[ti], dim=-1)[..., : a.shape[-1]].numpy())
        return out
