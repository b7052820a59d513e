"""The port's NumPy plan code is bit-equal to the JAX package's.

Scales, suggested slice lengths, the filterbank design (windows, duals,
centre bins, supports, index ranges, buckets) and the per-bucket transform
tables are plain NumPy in both packages; the port keeps a copy, so every
value must match exactly (no tolerance).
"""

import numpy as np
import pytest

import torch_port_utils  # noqa: F401  (thread settings)

from xumx_slicq_tpu.ops import filterbank as jfb
from xumx_slicq_tpu.ops import fscale as jfs
from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
from xumx_slicq_torch.ops import filterbank as tfb
from xumx_slicq_torch.ops import fscale as tfs
from xumx_slicq_torch.ops.slicqt import SliCQT

PLAN_CASES = [
    ("bark", 262, 32.9),
    ("mel", 12, 200.0),
    ("linear", 96, 40.0),
    ("mrstft", 576, 1.0),
]


@pytest.mark.parametrize("name,fbins,fmin", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_bit_equal(name, fbins, fmin):
    js, ts = jfs.make_scale(name, fbins, fmin), tfs.make_scale(name, fbins, fmin)
    for a, b in zip(js(), ts()):
        np.testing.assert_array_equal(a, b)
    sl, tr = js.suggested_sllen_trlen(44100.0)
    assert ts.suggested_sllen_trlen(44100.0) == (sl, tr)
    jp = jfb.design_filterbank(js, sl, tr, 44100.0)
    tp = tfb.design_filterbank(ts, sl, tr, 44100.0)
    assert (jp.nn, jp.nfreqs, jp.ncoefs) == (tp.nn, tp.nfreqs, tp.ncoefs)
    np.testing.assert_array_equal(jp.rfbas, tp.rfbas)
    np.testing.assert_array_equal(jp.M, tp.M)
    for field in ("g", "gd", "wins"):
        for a, b in zip(getattr(jp, field), getattr(tp, field)):
            np.testing.assert_array_equal(a, b)
    assert [(b.f_start, b.f_count, b.M) for b in jp.buckets] == [(b.f_start, b.f_count, b.M) for b in tp.buckets]
    np.testing.assert_array_equal(jfb.hannwin(sl // 4), tfb.hannwin(sl // 4))


@pytest.mark.parametrize("cfg", [dict(scale="mel", fbins=12, fmin=200.0), dict()], ids=["mel-12", "bark-262"])
def test_transform_tables_bit_equal(cfg):
    """Per-bucket analysis and synthesis weights, the un-rotation phase and
    the slice window: the same NumPy values the JAX package embeds."""
    j, t = JaxSliCQT(**cfg), SliCQT(device="cpu", **cfg)
    assert (j.sllen, j.trlen, j.nn, j.nh, j.nfreqs, j.inv_overlap) == (t.sllen, t.trlen, t.nn, t.nh, t.nfreqs, t.inv_overlap)
    assert len(j.buckets) == len(t.buckets)
    for jb, tb in zip(j.buckets, t.buckets):
        assert (jb.f_start, jb.f_count, jb.M, jb.neg_lo, jb.neg_hi) == (tb.f_start, tb.f_count, tb.M, tb.neg_lo, tb.neg_hi)
        np.testing.assert_array_equal(jb.starts, tb.starts)
        for name in ("fwd_w", "inv_ramp", "w_pos"):
            np.testing.assert_array_equal(getattr(jb, name), getattr(tb, name))
        assert (jb.w_neg is None) == (tb.w_neg is None)
        if jb.w_neg is not None:
            np.testing.assert_array_equal(jb.w_neg, tb.w_neg)
    np.testing.assert_array_equal(j._unrot, t._unrot)
    np.testing.assert_array_equal(np.asarray(j._slice_window), t._window.numpy())
    assert t.block_shapes(1, 2, 44100) == j.block_shapes(1, 2, 44100)
    assert (t.n_slices(12345), t.max_length(7)) == (j.n_slices(12345), j.max_length(7))
    assert t.config_dict() == j.config_dict()
