"""Why the port's realtime CDAE train step, from the port's seeded init,
misses the JAX package's gradient of `blocks.0.enc1_w` by ~1.4e-3: both
packages' step in float32 and in float64, and the port's ReLU gates.

    python tests/torch_realtime_grad_f64.py

The setup is tests/test_torch_training.py's step test (mel-12, batch 2 of
0.3 s, one silent stem, BatchNorm and whitening jittered) with the weights
of `Unmix(shapes, seed=1)` moved into JAX through the reference's names.
Prints, per parameter tensor, ||a - b|| / max(||b||, 1e-3 of the largest
norm) for port32-jax32, port64-jax64, jax32-jax64 and port32-port64, and
the ReLU inputs of block 0 whose sign differs between the port's float32
and float64 runs. Not a test: it compiles the JAX step twice (~1 min).
Float64 runs in a second process, as JAX fixes x64 at start-up.
"""

import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

LR, WD, BATCH = 1e-3, 1e-5, 2


def _setup():
    import jax

    from torch_port_utils import MEL12, TINY_LEN, noise
    from xumx_slicq_tpu.models.torch_import import import_cdae_state_dict
    from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.models.convert import to_reference_state_dict

    stems = noise(0, (BATCH, 4, 2, TINY_LEN), 0.1)
    stems[0, 1] = 0.0
    batch = np.concatenate([stems.sum(1, keepdims=True), stems], axis=1)
    shapes = JaxSliCQT(**MEL12).block_shapes(BATCH, 2, TINY_LEN)
    sd = {k: v.numpy() for k, v in to_reference_state_dict(Unmix(shapes, seed=1, device="cpu")).items()}
    params, stats = import_cdae_state_dict(sd, len(shapes))
    rng = np.random.default_rng(1)

    def jitter(path, a):       # tests/test_torch_training.py::weights
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if "bn" in name and "scale" in name:
            return a * rng.uniform(0.8, 1.25, a.shape).astype(np.float32)
        if "bn" in name and "bias" in name:
            return a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        if "input_mean" in name:
            return a + rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        if "input_scale" in name:
            return a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return shapes, batch, jax.tree_util.tree_map_with_path(jitter, params), jax.tree.map(np.array, stats)


def _grads(double: bool):
    """Both packages' realtime step gradients (float64 numpy, port names)
    and the port's block-0 ReLU inputs."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    import xumx_slicq_torch.models.cdae as cdae
    from torch_port_utils import MEL12, keep_grads
    from xumx_slicq_tpu.models import Unmix as JaxUnmix
    from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
    from xumx_slicq_tpu.training import make_train_step as jax_make_train_step
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.models.convert import params_from_jax
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.training import make_train_step

    shapes, batch, params, stats = _setup()
    dt = np.float64 if double else np.float32
    as64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    stats64, sd = as64(stats), params_from_jax(params, stats)
    opt = optax.chain(keep_grads(), optax.adamw(LR, weight_decay=WD))
    jstep, _ = jax_make_train_step(JaxSliCQT(**MEL12), JaxUnmix(shapes, realtime=True), opt)
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)
    _, _, state, _ = jstep(cast(params), cast(stats), opt.init(cast(params)), jnp.asarray(batch, dt))
    gj = params_from_jax(as64(state[0]), stats64)

    model = Unmix(shapes, realtime=True, device="cpu")
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    if double:
        model.double()
    step, _ = make_train_step(SliCQT(device="cpu", **MEL12), model,
                              torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD))
    relu_in, relu = [], torch.relu

    def spy(h):                # the first three ReLUs are block 0's
        if len(relu_in) < 3:
            relu_in.append(h.detach().double().clone())
        return relu(h)

    cdae.torch.relu = spy
    try:
        x = torch.from_numpy(batch)
        step(x.double() if double else x)
    finally:
        cdae.torch.relu = relu
    return {"jax": gj, "port": {n: p.grad.double() for n, p in model.named_parameters()}, "relu": relu_in}


def main():
    if "--child" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        double = "--f64" in sys.argv
        if double:
            jax.config.update("jax_enable_x64", True)
        with open(sys.argv[-1], "wb") as f:
            pickle.dump(_grads(double), f)
        return
    import torch

    from torch_port_utils import norm_rel

    res = {}
    with tempfile.TemporaryDirectory() as d:
        for tag in ("f32", "f64"):
            out = Path(d) / tag
            subprocess.run([sys.executable, __file__, "--child", f"--{tag}", str(out)], check=True)
            res[tag] = pickle.loads(out.read_bytes())
    g32, g64 = res["f32"], res["f64"]
    norms = {n: float(torch.linalg.vector_norm(g64["jax"][n])) for n in g64["port"]}
    floor = 1e-3 * max(norms.values())
    rows = sorted(((norm_rel(g32["port"][n], g32["jax"][n], floor), n) for n in norms), reverse=True)
    print(f"{'tensor':28s} port32-jax32 port64-jax64 jax32-jax64 port32-port64")
    for _, n in rows[:6]:
        vals = (norm_rel(g32["port"][n], g32["jax"][n], floor), norm_rel(g64["port"][n], g64["jax"][n], floor),
                norm_rel(g32["jax"][n], g64["jax"][n], floor), norm_rel(g32["port"][n], g64["port"][n], floor))
        print(f"{n:28s} " + " ".join(f"{v:12.3e}" for v in vals))
    print("largest port64-jax64 over all tensors: %.3e" %
          max(norm_rel(g64["port"][n], g64["jax"][n], floor) for n in norms))
    for i, (a, b) in enumerate(zip(g32["relu"], g64["relu"])):
        flips = ((a > 0) != (b > 0)).nonzero()
        print(f"block 0 ReLU {i + 1}: {len(flips)} of {a.numel()} inputs change sign between float32 and float64"
              + "".join(f"; {float(a[tuple(j)]):.3e} / {float(b[tuple(j)]):.3e}" for j in flips[:3]))


if __name__ == "__main__":
    main()
