"""Readings behind each limit of `correct`, on the card, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,...,12 --control-seeds 21,22,23

For each of --seeds, the program's reading: what the cell's timed call
produces (the demix cells' compared tracks through `Separator.forward`; the
train cell's first three steps through the train step) against the
reference, as a run compares them. For each of --control-seeds, the
control's: the reference computed with TF32 on (the precision below the
configured float32 with TF32 off) put in the program's place; for the train
cell also the fault of half the batch left out (the mean over the rest),
planted in the reference put in the program's place. A state left
unchanged reads 1 on `change_gap` by its definition and needs no run. One
JSON line per reading; the benchmark's own runs do not run this. It reads
the cells that BENCHMARK.json holds back too (tests/data/held_cells.json).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def demix_readings(config, p, seeds, control_seeds, device):
    import numpy as np

    import system
    from reference.demix import Demixer
    from traffic import demix_catalog as dc

    harness.set_precision(config["tf32"])
    lengths = dc.pool_lengths(p, config["transform"]["fs"])
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.time()
        pool = dc.make_pool(lengths, p["rms"], seed, device)
        sep = system.separator(config, system.make_weights(config, seed, device), device)
        checked = dc.checked_tracks(lengths, config, sep.slicqt.sllen, np.random.default_rng(seed),
                                    p["check_per_batch"])
        prog = [sep.forward(pool[i])[:, 0] for i in checked]
        del sep
        free()
        w = system.make_weights(config, seed, device)
        harness.set_precision(config["tf32"])
        ref = Demixer(config, w, device).demix([pool[i][0] for i in checked])

        def gap(out):
            return float(np.max([np.abs(a - r).max() / np.abs(r).max() for a, r in zip(out, ref)]))   # NaN stays NaN

        yield {"seed": seed, "side": "program", "stem_gap": gap(prog), "tracks": checked, "s": time.time() - t0}
        if seed in control_seeds:
            harness.set_precision(True)
            low = Demixer(config, w, device).demix([pool[i][0] for i in checked])
            harness.set_precision(config["tf32"])
            yield {"seed": seed, "side": "control_tf32", "stem_gap": gap(low), "s": time.time() - t0}
        free()


def train_readings(config, p, seeds, control_seeds, device):
    import system
    from traffic import train_steps as ts

    harness.set_precision(config["tf32"])
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.time()
        batches = ts.make_batches(p, config["nb_channels"], config["transform"]["fs"], seed, device)
        step, model, opt = system.train_step(config, system.make_weights(config, seed, device), device,
                                             p["lr"], p["weight_decay"])
        prog = ts.first_steps(step, model, opt, batches, device)
        del step, model, opt
        free()
        w = system.make_weights(config, seed, device)
        harness.set_precision(config["tf32"])
        ref = ts.reference_steps(config, w, batches, device, p)
        yield {"seed": seed, "side": "program", **ts.compare(prog, ref), **ts.step_gaps(prog, ref),
               "s": time.time() - t0}
        if seed in control_seeds:
            harness.set_precision(True)
            low = ts.reference_steps(config, w, batches, device, p)
            harness.set_precision(config["tf32"])
            yield {"seed": seed, "side": "control_tf32", **ts.compare(low, ref), **ts.step_gaps(low, ref),
                   "s": time.time() - t0}
            half = ts.reference_steps(config, w, [b[: b.shape[0] // 2] for b in batches], device, p)
            yield {"seed": seed, "side": "fault_half_batch", **ts.compare(half, ref), **ts.step_gaps(half, ref),
                   "s": time.time() - t0}
        free()


def main(argv=None):
    harness.setup_env()
    import torch

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    wl, config, traffic = harness.cell_files(args.workload)
    harness.check_cards(wl["chips"])
    device = torch.device("cuda:0")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    readings = train_readings if traffic["kind"] == "train_steps" else demix_readings
    print(json.dumps({"card": harness.power_limit(), "cell": args.workload}), flush=True)
    for r in readings(config, traffic, seeds, control, device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
