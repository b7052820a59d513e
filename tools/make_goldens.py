#!/usr/bin/env python3
"""Build the JAX goldens of the port's tests (tests/goldens/*.npz) from the
JAX package, on the CPU.

    python tools/make_goldens.py [NAME ...]

Each golden is an output of the JAX package that depends only on seeded
inputs (tests/torch_goldens.py): the test modules named in
`torch_goldens.MODULES` list theirs in `GOLDENS`, each built from the same
seeded weights and batches as the test that reads it, with a fingerprint
of those inputs. Builds every golden by default. The `slow` twin of each
test recomputes its golden live:
`python -m pytest -m slow tests/ -k golden_matches_live_jax`.
"""

import argparse
import importlib
import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parent.parent / "tests"


def registry() -> dict:
    """name -> the function that makes it, over every module that lists goldens."""
    sys.path[:0] = [str(TESTS), str(TESTS.parent)]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch_goldens

    out = {}
    for module in torch_goldens.MODULES:
        out.update(importlib.import_module(module).GOLDENS)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("names", nargs="*", help="goldens to build (default: every one)")
    args = ap.parse_args(argv)
    makers = registry()
    import torch_goldens

    unknown = set(args.names) - set(makers)
    if unknown:
        ap.error(f"unknown goldens {sorted(unknown)}; known: {sorted(makers)}")
    total = 0
    for name in args.names or sorted(makers):
        t0 = time.time()
        inputs, arrays = makers[name]()
        path = torch_goldens.save(name, inputs, arrays)
        total += path.stat().st_size
        print(f"{path.relative_to(TESTS.parent)}: {path.stat().st_size} bytes, built in {time.time() - t0:.1f} s",
              flush=True)
    print(f"total: {total} bytes")


if __name__ == "__main__":
    main()
