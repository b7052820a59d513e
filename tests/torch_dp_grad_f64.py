"""Where a data-parallel train step's gradients part from one process's:
the dp = 2 step and the one-process step, each in float32 and in float64.

    python tests/torch_dp_grad_f64.py

The setup is tests/test_torch_parallel.py's gradient comparison
(`torch_port_utils.step_gradients`: the seeded mel-12 model, every loss
term, the global batch of 4 items of 0.3 s); 2 CPU ranks over gloo. The
CDAE runs offline in float32 and realtime in float32 and float64 (K2, the
offline model's Wiener-EM, takes float32 only; dp and one process differ
only in the mask model's cross-rank BatchNorm, which both variants share);
the LSTM offline in float32 (K5 takes float32 only). Prints, per case, chip_smoke.py's worst bound ratio
|g - g1| / (1e-2 |g1| + 1e-5 |all of g1|) and the worst tensors by
||dp - one|| / ||one|| (tensors above a floor of 1e-5 of the whole
gradient's norm). If the two float64 runs agree to ~1e-7 (rounding of
float64 sums), the float32 gap is float32 rounding, not a fault of the dp
path. Not a test: 2 ranks, ~1-2 min.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

RTOL, FLOOR = 1e-2, 1e-5          # chip_smoke.py's MESH_GRAD_RTOL, MESH_GRAD_FLOOR


# (lstm, realtime, double)
CASES = [(False, False, False), (False, True, False), (False, True, True), (True, False, False)]


def _rank(rank: int) -> dict:
    """Every case on this rank of a dp = 2 mesh; rank 0 also runs the
    one-process steps."""
    from torch_port_utils import grad_batch, step_gradients
    from xumx_slicq_torch.parallel.mesh import make_mesh

    out = {}
    for lstm, realtime, double in CASES:
        dp = step_gradients(make_mesh(2), lstm, grad_batch(), double, realtime)
        one = step_gradients(None, lstm, grad_batch(), double, realtime) if rank == 0 else None
        out[lstm, realtime, double] = (dp, one)
    return out if rank == 0 else None


def main():
    import torch

    from torch_port_utils import norm_rel
    from xumx_slicq_torch.parallel.mesh import spawn

    def whole(g):
        return float(torch.sqrt(sum(t.double().norm() ** 2 for t in g.values())))

    torch.set_num_threads(1)
    res = spawn(_rank, ["cpu", "cpu"])[0]
    for lstm, realtime, double in CASES:
        dp, one = res[lstm, realtime, double]
        name = f"{'lstm' if lstm else 'cdae'} {'realtime' if realtime else 'offline'} {'f64' if double else 'f32'}"
        ratio = {n: float((dp[n] - one[n]).double().norm()) / (RTOL * float(one[n].double().norm())
                                                               + FLOOR * whole(one)) for n in one}
        above = [n for n in one if float(one[n].double().norm()) > FLOOR * whole(one)]
        rel = {n: norm_rel(dp[n], one[n]) for n in above}
        worst = sorted(above, key=rel.get, reverse=True)[:4]
        print(f"{name}: worst bound ratio {max(ratio.values()):.3e} ({max(ratio, key=ratio.get)}); "
              f"dp-one over {len(above)} of {len(one)} tensors, largest: "
              + ", ".join(f"{n} {rel[n]:.3e}" for n in worst))
        if double:
            dp32, one32 = res[lstm, realtime, False]
            print(f"  float32 against float64: one process {max(norm_rel(one32[n], one[n]) for n in above):.3e}, "
                  f"dp {max(norm_rel(dp32[n], dp[n]) for n in above):.3e} (largest over the same tensors)")


if __name__ == "__main__":
    main()
