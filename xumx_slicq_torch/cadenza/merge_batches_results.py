"""Merge per-batch evaluation CSV shards into scores.csv
(reference cadenza/merge_batches_results.py:8-25).

The port's copy of cadenza/merge_batches_results.py, unchanged."""

import argparse
import csv
from pathlib import Path


def merge(exp_folder: str, output: str = "scores.csv"):
    exp = Path(exp_folder)
    shards = sorted(exp.glob("scores_*-*.csv"))
    if not shards:
        raise FileNotFoundError(f"no score shards in {exp}")
    rows = []
    header = None
    for shard in shards:
        with open(shard, newline="") as f:
            r = list(csv.reader(f))
        header = r[0]
        rows.extend(r[1:])
    out = exp / output
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    print(f"merged {len(shards)} shards, {len(rows)} rows -> {out}")
    if rows:
        scores = [float(r[2]) for r in rows]
        print(f"mean HAAQI: {sum(scores)/len(scores):.4f}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp-folder", type=str, required=True)
    p.add_argument("--output", type=str, default="scores.csv")
    args = p.parse_args(argv)
    merge(args.exp_folder, args.output)


if __name__ == "__main__":
    main()
