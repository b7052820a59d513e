"""The model's operations for the whole-step shares (`demix_mfu`,
`train_mfu`), worked out from the configuration with the reference's own
plan, independent of how the program computes them.

Counted: 2 x the multiply-adds of the mask model's products (the CDAE's
four convolutions as `k4.layer_macs` counts them; the LSTM's
down-projection, input projections, recurrent products and two output
layers), and the FFTs at 5 N log2 N for a complex transform of N points
and 2.5 N log2 N for a real one: the analysis rFFT over each slice and
iFFT over M of each bucket, the synthesis FFT over M and irFFT, for each
channel (and each target in synthesis). Elementwise work (gather, weights,
Wiener-EM, losses) is not counted.

Training (`train_step_ops`): the transforms of the data (mixture and 4
targets, no gradient) once; the mask model's products three times
(forward, data gradient, weight gradient). The Wiener-EM and the losses
are elementwise and not counted.
"""

import functools
import math

from reference import models
from reference.plan import design_filterbank, make_scale
from work import k4


@functools.lru_cache(maxsize=4)
def _plan(scale, fbins, fmin, fmax, fs):
    scl = make_scale(scale, fbins, fmin, fmax)
    sllen, trlen = scl.suggested_sllen_trlen(fs)
    return design_filterbank(scl, sllen, trlen, fs)


def _plan_slices(config, length):
    t = config["transform"]
    plan = _plan(t["scale"], t["fbins"], t["fmin"], t.get("fmax", 22050.0), t["fs"])
    hhop = plan.Ls // 4
    S = (-(-length // hhop) + 1) // 2 + 1
    return plan, S


def geometry(config) -> dict:
    """The configuration's bucket table, which the kernels' work counts read
    beside the recorded shapes: channels, targets, each bucket's (F, M), the
    CDAE's frequency kernels and hidden sizes, the LSTM's hidden sizes, and
    the slices of one chunk."""
    plan, S = _plan_slices(config, config["chunk_size"])
    C = config["nb_channels"]
    return {"channels": C, "targets": models.NB_TARGETS, "slices": S,
            "buckets": [(b.f_count, b.M) for b in plan.buckets],
            "fphi": [models.freq_filter(b.f_count) for b in plan.buckets],
            "lstm_hidden": [models.lstm_sizes(C, b.f_count)[2] for b in plan.buckets],
            "hidden_size_1": config.get("hidden_size_1", 50), "hidden_size_2": config.get("hidden_size_2", 51),
            "time_filter_2": config.get("time_filter_2", 4)}


def _fft(n, real=False):
    return (2.5 if real else 5.0) * n * math.log2(n)


def transform_ops(config, batch, length, synthesis=True, targets=4):
    plan, S = _plan_slices(config, length)
    C = config["nb_channels"]
    per_slice = _fft(plan.nn, real=True) + sum(b.f_count * _fft(b.M) for b in plan.buckets)
    ops = batch * C * S * per_slice
    if synthesis:
        ops += targets * batch * C * S * per_slice
    return ops


def mask_model_ops(config, batch, length):
    plan, S = _plan_slices(config, length)
    C, n = config["nb_channels"], models.NB_TARGETS
    total = 0.0
    for b in plan.buckets:
        F, T = b.f_count, b.M
        if config["model"] == "cdae":
            macs = k4.layer_macs(batch, C, F, S, T, models.freq_filter(F), n, config["hidden_size_1"],
                                 config["hidden_size_2"], config["time_filter_2"])
            total += 2.0 * sum(macs)
        else:
            h1, down, H = models.lstm_sizes(C, F)
            rows = batch * S * T
            macs = (F * C * h1 if down else 0) + 2 * (h1 * 4 * H + 2 * (2 * H * 4 * H)) + 2 * 4 * H * H * 3
            macs += 2 * h1 * h1 + h1 * F * C
            total += 2.0 * n * rows * macs
    return total


def demix_chunk_ops(config):
    """Operations of the model for one chunk of `chunk_size` samples."""
    L = config["chunk_size"]
    return transform_ops(config, 1, L) + mask_model_ops(config, 1, L)


def train_step_ops(config, batch, length):
    return transform_ops(config, batch, length, synthesis=False) * 5 + 3 * mask_model_ops(config, batch, length)
