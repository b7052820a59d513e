"""The system under test: the PyTorch port's Separator and train step,
built from a configuration file with the benchmark's seeded weights.

Nothing else of the port is used: the weights, inputs, timing, traces and
the reference are the benchmark's own.
"""

import torch

import weights as weightlib
from reference import models


def _unmix(config, device, seq_len=None):
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT

    t = config["transform"]
    slicqt = SliCQT(scale=t["scale"], fbins=t["fbins"], fmin=t["fmin"], fmax=t.get("fmax", 22050.0),
                    fs=t["fs"], device=device)
    shapes = slicqt.block_shapes(1, config["nb_channels"], seq_len or int(config["seq_dur"] * t["fs"]))
    model = Unmix(shapes, lstm=config["model"] == "lstm", realtime=config["realtime"],
                  wiener_iterations=config["wiener_iterations"],
                  hidden_size_1=config.get("hidden_size_1", 50), hidden_size_2=config.get("hidden_size_2", 51),
                  time_filter_2=config.get("time_filter_2", 4), device=device)
    return slicqt, model, shapes


def make_weights(config, seed: int, device):
    """The run's weights from its seed, in the reference's layout."""
    return weightlib.make(models.param_spec(config, _reference_shapes(config)), seed, device)


def _reference_shapes(config):
    from reference.plan import design_filterbank, make_scale

    t = config["transform"]
    scl = make_scale(t["scale"], t["fbins"], t["fmin"], t.get("fmax", 22050.0))
    sllen, trlen = scl.suggested_sllen_trlen(t["fs"])
    plan = design_filterbank(scl, sllen, trlen, t["fs"])
    return [(1, config["nb_channels"], b.f_count, 1, b.M) for b in plan.buckets]


def load_weights(model, w: dict):
    """The seeded weights into the port's model; every leaf the model has is given."""
    missing, unexpected = model.load_state_dict(w, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weights do not fit the model: missing {missing[:5]}, unexpected {unexpected[:5]}")


def separator(config, w: dict, device):
    """The port's Separator on `device`, its model in eval mode with the seeded weights."""
    from xumx_slicq_torch.separator import Separator

    slicqt, model, _ = _unmix(config, device)
    load_weights(model, w)
    return Separator(slicqt, model, sample_rate=config["transform"]["fs"], chunk_size=config["chunk_size"],
                     device=device)


def train_step(config, w: dict, device, lr: float, weight_decay: float):
    """(train_step, model, optimizer): the port's make_train_step with
    AdamW, as its trainer builds them (SD-SDR off, mask-sum 1)."""
    from xumx_slicq_torch.training import make_train_step

    slicqt, model, _ = _unmix(config, device)
    load_weights(model, w)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=weight_decay)
    step, _ = make_train_step(slicqt, model, opt)
    return step, model, opt
