"""Random weights from the seed, made on the device in one draw.

Every leaf of `reference.models.param_spec` gets a slice of one
`torch.rand` call on a generator of the run's device seeded with --seed,
mapped to its range: a weight U(+-1 / sqrt(fan-in)) as torch's default
init, a bias U(+-its layer's bound), and the BatchNorm statistics and
affines and the whitening drawn off their defaults, as the measured
package's own card checks perturb them: at the defaults the folded biases
are 0 and the whitening is the identity, so a kernel that misread them
would pass.
"""

import math
from typing import Dict, List, Tuple

import torch

RANGES = {
    "weight": (0.8, 1.2),            # BatchNorm affine
    "bias": (-0.1, 0.1),
    "running_mean": (-0.1, 0.1),
    "running_var": (0.6, 1.6),
    "whiten_mean": (-0.2, 0.0),      # stored as -mean
    "whiten_scale": (0.5, 2.0),      # stored as 1 / scale
}


def _range(init: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if init == "fan":
        b = (math.prod(shape[1:]) if len(shape) == 4 else shape[-1]) ** -0.5
        return -b, b
    if init.startswith("bound:"):
        b = float(init.split(":", 1)[1])
        return -b, b
    return RANGES[init]


def make(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on device} for every (name, shape, init) of spec."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    u = torch.rand(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        lo, hi = _range(init, shape)
        out[name] = (u[off: off + n] * (hi - lo) + lo).view(shape)
        off += n
    return out
