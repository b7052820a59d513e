"""Catalog demixing: one client calls `Separator.forward` track after track
(a closed loop), each track's stems back in host memory before the next.

Parameters (the traffic file): `tracks`, the pool's size; `mean_s` and
`log_sigma`, the log-normal its lengths are the (i + 0.5) / tracks
quantiles of (the same lengths for every seed); `rms`, the noise level of
the stereo audio; `check_per_batch`, how many tracks of each chunk-batch
size the run compares with the reference; `trace_passes`, passes over the
pool that a traced run profiles; `assumed`, the parameters that no public
catalog gives (read by no code).

The seed sets the audio and the order in which the pool is cycled (a new
permutation each pass), and which tracks are compared; never the lengths,
so every seed does the same work. Set-up: the weights, the Separator, the
pool, and one pass over the pool in the seeded order (every chunk-batch
shape and host buffer the window uses). The window: tracks in the seeded
order until `seconds` have passed; the track in flight then finishes, and
the window ends with it. `demix_rate` is the audio seconds demixed over the window's
seconds, `track_latency_p95_ms` the 95th percentile over every track of
the window (from the call to its stems in host memory).
"""

import gc
import math
import statistics
import time

import numpy as np
import torch

import system
from harness import Profile, failures, p95, set_precision
from reference.demix import Demixer, chunk_plan
from work.model import demix_chunk_ops, geometry


def pool_lengths(p: dict, fs: float):
    mu = math.log(p["mean_s"]) - p["log_sigma"] ** 2 / 2
    nd = statistics.NormalDist()
    secs = [math.exp(mu + p["log_sigma"] * nd.inv_cdf((i + 0.5) / p["tracks"])) for i in range(p["tracks"])]
    return [int(round(s * fs)) for s in secs]


def make_pool(lengths, rms: float, seed: int, device):
    """Stereo noise tracks (1, 2, N), drawn on the device from the seed, in host memory."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = (torch.randn(2 * sum(lengths), generator=g, device=device) * rms).cpu().numpy()
    out, off = [], 0
    for n in lengths:
        out.append(flat[off: off + 2 * n].reshape(1, 2, n))
        off += 2 * n
    return out


def checked_tracks(lengths, config, sllen, rng, per_batch):
    """The pool tracks a run compares: per chunk-batch size, `per_batch` of its tracks drawn by rng."""
    by_batch = {}
    for i, n in enumerate(lengths):
        by_batch.setdefault(chunk_plan(n, config["chunk_size"], sllen)[2][0][2], []).append(i)
    return sorted(int(j) for b in sorted(by_batch)
                  for j in rng.choice(by_batch[b], size=min(per_batch, len(by_batch[b])), replace=False))


def run(ctx) -> dict:
    config, p, device, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    fs = config["transform"]["fs"]
    rng = np.random.default_rng(seed)
    ctx.mark("imports")
    w = system.make_weights(config, seed, device)
    ctx.mark("weights")
    sep = system.separator(config, w, device)
    del w
    ctx.mark("separator")
    lengths = pool_lengths(p, fs)
    pool = make_pool(lengths, p["rms"], seed, device)
    ctx.mark("pool")
    checked = checked_tracks(lengths, config, sep.slicqt.sllen, rng, p["check_per_batch"])

    def passes():
        while True:
            yield from rng.permutation(len(pool))

    order = passes()
    held = {}
    for _ in range(len(pool)):                       # warm-up: every shape, the host buffers the window holds
        i = next(order)
        est = sep.forward(pool[i])
        if i in checked:
            held[i] = est
    held.clear()
    ctx.mark("warm-up")
    kept, lat, audio = {}, [], 0
    if ctx.trace:
        n_units = p["trace_passes"] * len(pool)
        with Profile(device, record_shapes=True) as prof:
            ctx.window_start()
            for _ in range(n_units):
                i = next(order)
                est = sep.forward(pool[i])
                if i in checked and i not in kept:
                    kept[i] = est
        chunks = sum(-(-lengths[i] // config["chunk_size"]) for i in range(len(pool))) * p["trace_passes"]
        summary = prof.summary
        summary.update(units=n_units, demix_ops=chunks * demix_chunk_ops(config), geometry=geometry(config))
    else:
        ctx.window_start()
        t0 = time.perf_counter()
        while True:
            i = next(order)
            ts = time.perf_counter()
            est = sep.forward(pool[i])
            te = time.perf_counter()
            lat.append(te - ts)
            audio += lengths[i] / fs
            if i in checked and i not in kept:
                kept[i] = est
            if te - t0 >= ctx.seconds:
                break
        window = te - t0
        summary = None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted = n_units if ctx.trace else len(lat)
    del sep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ctx.mark("window closed")
    # the reference, from the same seed's weights and the same audio, in the configured precision
    set_precision(config["tf32"])
    ref = Demixer(config, system.make_weights(config, seed, device), device)
    order_k = sorted(kept)
    stems = ref.demix([pool[i][0] for i in order_k]) if kept else []
    ctx.mark("reference")
    gaps = []
    for i, r in zip(order_k, stems):
        d = float(np.abs(kept[i][:, 0] - r).max() / np.abs(r).max())
        gaps.append(d if math.isfinite(d) else 1e300)
    missing = [i for i in checked if i not in kept]
    limit = ctx.limits["stem_gap"]
    failed = sum(bool(failures({"stem_gap": g}, ctx.limits)) for g in gaps) + len(missing)
    values = {}
    if not ctx.trace:
        values = {"demix_rate": audio / window, "track_latency_p95_ms": 1e3 * p95(lat)}
    return dict(values=values, summary=summary, attempted=attempted, failed=failed, memory_peak_bytes=peak,
                checks={"stem_gap": {"value": max(gaps) if gaps else None, "limit": limit}},
                correct=failed == 0 and len(gaps) > 0)
