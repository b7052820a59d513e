"""Training at the published batch: the port's train step, step after
step, each ending in its loss read back on the host.

Parameters (the traffic file): `batch` excerpts of `seconds` each (a
mixture and its 4 stems), `pool` batches made from the seed (stereo noise
stems at `rms`, the mixture their sum) in page-locked host memory and
copied to the card each step; AdamW at `lr` and `weight_decay`;
`trace_steps` steps in a traced run. The data loader is left out.

Set-up builds one train step (model, AdamW state) and drives it through
its first three steps on batches 0, 1 and 2 (the window's own call and
feed), keeping what the check compares: each step's loss, each leaf's
first gradient as AdamW received it (its first moment after one step over
1 - beta1) and each leaf's change after the three. The window continues
the same object from step 4. `train_step_ms` is the window's seconds over
the steps it completed.

The check (`compare`): the reference's three steps from the same weights
and batches. Per step the loss's relative gap; per leaf the gap between
the two norms of the first gradient, and of the change after three steps,
each over the larger of the reference leaf's norm and the median leaf's;
the worst of each. Leaves whose reference gradient is under a thousandth
of the median leaf's move under AdamW by rounding alone and are left out
of the change.
"""

import gc
import math
import statistics
import time

import torch

import system
from harness import Profile, failures, set_precision
from reference.train import Trainer
from work.model import geometry, train_step_ops

BETA1 = 0.9


def make_batches(p: dict, channels: int, fs: float, seed: int, device):
    """`pool` batches (batch, 5, C, L) in page-locked host memory: the mixture, then 4 stems."""
    L = int(p["seconds"] * fs)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = []
    for _ in range(p["pool"]):
        stems = torch.randn((p["batch"], 4, channels, L), generator=g, device=device) * p["rms"]
        b = torch.cat([stems.sum(1, keepdim=True), stems], dim=1)
        out.append(b.cpu().pin_memory() if device.type == "cuda" else b.cpu())
    return out


def norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def worst(gaps) -> float:
    """The largest gap, or NaN where any gap is NaN (Python's max would pass one over)."""
    gaps = list(gaps)
    return math.nan if any(math.isnan(g) for g in gaps) else max(gaps)


def worst_gap(prog: dict, ref: dict, keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers the check holds to their limits; a NaN loss or norm on either side reads NaN, which fails."""
    loss = worst(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
    return {"loss_gap": loss, "grad_gap": worst_gap(prog["grad"], ref["grad"], list(ref["grad"])),
            "change_gap": worst_gap(prog["change"], ref["change"], moving)}


def step_gaps(prog: dict, ref: dict) -> dict:
    """For a look at where the gaps come from: each step's loss gap, and the
    worst-gap leaves of the first gradient and of the change."""
    g_med = statistics.median(ref["grad"].values())
    c_med = statistics.median(ref["change"].values())
    grad = sorted(ref["grad"], key=lambda k: -abs(prog["grad"][k] - ref["grad"][k]) / max(ref["grad"][k], g_med))
    change = sorted(ref["change"], key=lambda k: -abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med))
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
            "worst_grad_leaves": [(k, ref["grad"][k] / g_med) for k in grad[:3]],
            "worst_change_leaves": [(k, ref["change"][k] / c_med) for k in change[:3]]}


def first_steps(step, model, opt, batches, device, n=3) -> dict:
    """Drive the program's train step through its first n steps."""
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    losses, grad = [], None
    for i in range(n):
        losses.append(float(step(batches[i].to(device, non_blocking=True))))
        if i == 0:
            # a leaf AdamW never stepped has no first moment: it got no gradient
            grad = norms({k: opt.state[v]["exp_avg"] / (1 - BETA1) if "exp_avg" in opt.state[v]
                          else torch.zeros_like(v) for k, v in params.items()})
    change = norms({k: v.detach() - p0[k] for k, v in params.items()})
    return {"losses": losses, "grad": grad, "change": change}


def reference_steps(config, w, batches, device, p, n=3) -> dict:
    tr = Trainer(config, w, device, lr=p["lr"], weight_decay=p["weight_decay"])
    p0 = {k: v.clone() for k, v in tr.parameters().items()}
    losses, grad = [], None
    for i in range(n):
        out = tr.step(batches[i].to(device))
        losses.append(out["loss"])
        if i == 0:
            grad = norms(out["grads"])
        del out
    change = norms({k: v - p0[k] for k, v in tr.parameters().items()})
    return {"losses": losses, "grad": grad, "change": change}


def run(ctx) -> dict:
    config, p, device, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ctx.mark("imports")
    w = system.make_weights(config, seed, device)
    step, model, opt = system.train_step(config, w, device, p["lr"], p["weight_decay"])
    del w
    ctx.mark("train step")
    batches = make_batches(p, config["nb_channels"], config["transform"]["fs"], seed, device)
    ctx.mark("batches")
    prog = first_steps(step, model, opt, batches, device)
    ctx.mark("first steps")
    i = 3
    if ctx.trace:
        with Profile(device, record_shapes=False) as prof:
            ctx.window_start()
            for _ in range(p["trace_steps"]):
                float(step(batches[i % len(batches)].to(device, non_blocking=True)))
                i += 1
        L = int(p["seconds"] * config["transform"]["fs"])
        summary = prof.summary
        summary.update(units=p["trace_steps"], train_ops=p["trace_steps"] * train_step_ops(config, p["batch"], L),
                       geometry=geometry(config))
        values, attempted = {}, p["trace_steps"]
    else:
        sync()
        ctx.window_start()
        t0 = time.perf_counter()
        n = 0
        while True:
            float(step(batches[i % len(batches)].to(device, non_blocking=True)))
            i += 1
            n += 1
            te = time.perf_counter()
            if te - t0 >= ctx.seconds:
                break
        values, attempted, summary = {"train_step_ms": 1e3 * (te - t0) / n}, n, None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del step, model, opt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ctx.mark("window closed")
    set_precision(config["tf32"])
    ref = reference_steps(config, system.make_weights(config, seed, device), batches, device, p)
    ctx.mark("reference")
    got = compare(prog, ref)
    checks = {k: {"value": v, "limit": ctx.limits[k]} for k, v in got.items()}
    failed = len(failures(got, ctx.limits))
    return dict(values=values, summary=summary, attempted=attempted, failed=failed, memory_peak_bytes=peak,
                checks=checks, correct=failed == 0)
