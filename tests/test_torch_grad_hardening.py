"""Silent audio through the port's train step, on the CPU at mel-12: the
counterpart of tests/test_grad_hardening.py:42-59.

|X| and the angle have no gradient at 0, and zero coefficients occur in
padded and silent audio: one quiet batch must not abort training. An
all-zero batch and a batch with a silent stem and a half-silent mixture go
through one train step with every loss term (SD-SDR on), in float32 and
with bf16 operands, for the CDAE and for the LSTM (dropout on). The loss
and every parameter after AdamW must be finite. On the CPU this runs the
plain versions of the kernels' backward passes (K1b, K2b, K5b); on the card
`chip_smoke.py`'s phase `silent_train_step` runs the kernels themselves at
full width.
"""

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, MEL12, TINY_LEN

from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.training import make_train_step

BATCH = 2


def silent_batch(kind: str) -> np.ndarray:
    """(2, 5, 2, L) stacked (mix, 4 stems), as tests/test_grad_hardening.py
    makes them."""
    if kind == "all_zero":
        return np.zeros((BATCH, 5, 2, TINY_LEN), np.float32)
    batch = (np.random.default_rng(0).standard_normal((BATCH, 5, 2, TINY_LEN)) * 0.1).astype(np.float32)
    batch[:, 1] = 0.0                          # one silent target stem
    batch[0, 0, :, : TINY_LEN // 2] = 0.0      # a half-silent mixture (the padding pattern)
    return batch


@pytest.mark.parametrize("lstm", [False, True], ids=["cdae", "lstm"])
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["all_zero", "silent_stem"])
def test_silent_batch_finite_train_step(kind, amp, lstm):
    slicqt = SliCQT(device=DEVICE, **MEL12)
    model = Unmix(slicqt.block_shapes(BATCH, 2, TINY_LEN), lstm=lstm, amp=amp, seed=0, device=DEVICE)
    # optax.adamw(1e-3)'s defaults, as the JAX test's optimizer
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step, _ = make_train_step(slicqt, model, opt, sdr_mcoef=0.1)
    loss = float(step(torch.from_numpy(silent_batch(kind)), torch.Generator().manual_seed(0) if lstm else None))
    assert np.isfinite(loss), f"loss {loss} not finite on {kind}"
    bad = [n for n, p in model.named_parameters() if not torch.isfinite(p).all()]
    assert not bad, f"parameters not finite after a step on {kind}: {bad}"
