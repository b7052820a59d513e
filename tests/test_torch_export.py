"""The port's export: torch.export artifacts of the chunk pipeline on the CPU,
with K1, K2, K3 and K5 as registered ops (kernels/ops.py).

Tolerances: a saved and reloaded CPU artifact against the port's Separator
within 1e-5 absolute on 0.1-RMS input (the bound tests/test_export.py holds
the JAX package's artifacts to; the port's Separator is held to the JAX
package in tests/test_torch_separator.py). Both sides run the same ops on
the same weights, so the measured difference is ~1e-8. No JAX program is
compiled here.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, MEL12, TINY_ARGS, noise, port_model_dir

from xumx_slicq_torch.export import ExportedSeparator, build_chunk_fn, export_main, export_model
from xumx_slicq_torch.kernels import ops as kernel_ops
from xumx_slicq_torch.kernels import wiener_em as k2
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator

CHUNK = 16384
ATOL = 1e-5


@pytest.fixture(scope="module")
def cdae_export(tmp_path_factory):
    """A CDAE model dir and its CPU artifact at chunk 16384, exported with
    K2's table cache empty (the trace builds the tables itself)."""
    root = tmp_path_factory.mktemp("export_cdae")
    d = port_model_dir(root / "model")
    k2._device_tables.cache_clear()
    meta = export_model(d, root / "out", chunk_lens=(CHUNK,), device="cpu")
    return d, root / "out", meta


def test_cpu_artifact_reloads_and_matches_separator(cdae_export):
    d, out, meta = cdae_export
    assert (out / "manifest.json").exists() and (out / f"chunk_{CHUNK}.pt2").exists()
    saved = json.loads((out / "manifest.json").read_text())
    assert saved["format"] == "torch.export" and saved["device"] == "cpu" and saved["batch"] == 1
    assert saved["args"] == dict(TINY_ARGS, lstm=False, realtime=False)
    (chunk,) = saved["chunks"]
    assert chunk["chunk_len"] == CHUNK and chunk["file"] == f"chunk_{CHUNK}.pt2" and chunk["bytes"] > 1000
    x = noise(0, (1, 2, 20000), 0.1)
    est = ExportedSeparator(out, device="cpu")(x)
    ref = Separator.load(model_path=d, device=DEVICE, chunk_size=CHUNK)(x)
    assert est.shape == (4, 1, 2, 20000) and np.isfinite(est).all()
    np.testing.assert_allclose(est, ref, rtol=0, atol=ATOL)


def test_exported_graph_holds_one_node_per_kernel(cdae_export):
    _, out, meta = cdae_export
    counts = kernel_ops.graph_op_counts(ExportedSeparator(out, device="cpu").program(CHUNK).graph)
    assert counts == dict(synth_assembly=1, analysis_gather=1, cdae_folded=1, wiener_em_grouped=1,
                          lstm_recurrence=0, lstm_recurrence_cell=0)
    assert meta["chunks"][0]["ops"] == counts


def test_real_call_after_export_still_runs(cdae_export):
    """The export traced with K2's tables uncached: the cache must hold no
    placeholder of the trace, so a real call afterwards runs."""
    d, _, _ = cdae_export
    sep = Separator.load(model_path=d, device=DEVICE, chunk_size=CHUNK)
    x = noise(1, (1, 2, CHUNK), 0.1)
    with torch.no_grad():
        fn = build_chunk_fn(sep.slicqt, sep.model, CHUNK, sep._prepared)
        torch.export.export(fn, (torch.from_numpy(x),), strict=False)
        est = fn(torch.from_numpy(x))
    assert torch.isfinite(est).all()
    layout = sep.slicqt.layout(1, 2, sep.slicqt.n_slices(CHUNK))
    tables = k2._device_tables(layout, torch.device("cpu"))
    assert all(type(t) is torch.Tensor for t in tables.values())
    np.testing.assert_allclose(est.numpy(), sep(x), rtol=0, atol=ATOL)


def test_device_cache_skips_a_trace():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from xumx_slicq_torch.device import device_cache

    calls = []

    @device_cache
    def table(n, backward=False):
        calls.append((n, backward))
        return torch.arange(n)

    with FakeTensorMode():
        table(3)
    assert calls == [(3, False)]
    table(3)
    table(3)
    table(3, backward=True)
    table(3, backward=True)
    assert calls == [(3, False), (3, False), (3, True)]


def test_lstm_exports_with_three_recurrence_nodes(tmp_path):
    """The LSTM's recurrence is one opaque op a layer: the export takes
    seconds (the plain version's step walk is not traced) and the artifact
    runs a chunk as the Separator does (one chunk: the LSTM mixes the chunks
    of a chunk batch, so only a one-chunk input compares like with like)."""
    import time

    d = port_model_dir(tmp_path / "model", lstm=True)
    t0 = time.time()
    meta = export_model(d, tmp_path / "out", chunk_lens=(CHUNK,), device="cpu")
    assert time.time() - t0 < 30
    assert meta["chunks"][0]["ops"] == dict(synth_assembly=1, analysis_gather=1, cdae_folded=0,
                                           wiener_em_grouped=1, lstm_recurrence=3, lstm_recurrence_cell=0)
    x = noise(2, (1, 2, CHUNK), 0.1)
    est = ExportedSeparator(tmp_path / "out", device="cpu")(x)
    ref = Separator.load(model_path=d, device=DEVICE, chunk_size=CHUNK)(x)
    np.testing.assert_allclose(est, ref, rtol=0, atol=ATOL)


def test_realtime_export_has_no_wiener_node(tmp_path):
    """One whole chunk, so that both pad alike: the Separator runs an
    input shorter than a chunk at a shorter chunk length."""
    d = port_model_dir(tmp_path / "model", realtime=True)
    meta = export_model(d, tmp_path / "out", chunk_lens=(CHUNK,), device="cpu")
    assert meta["chunks"][0]["ops"] == dict(synth_assembly=1, analysis_gather=1, cdae_folded=1,
                                           wiener_em_grouped=0, lstm_recurrence=0, lstm_recurrence_cell=0)
    x = noise(3, (1, 2, CHUNK), 0.1)
    est = ExportedSeparator(tmp_path / "out", device="cpu")(x)
    ref = Separator.load(model_path=d, device=DEVICE, chunk_size=CHUNK)(x)
    np.testing.assert_allclose(est, ref, rtol=0, atol=ATOL)


def test_ops_on_cpu_are_the_plain_versions():
    """Each registered op's CPU implementation is its kernel's plain version."""
    from xumx_slicq_torch.kernels.lstm_recurrence import (RecurrenceLayout, _device_plan, layout_args,
                                                          lstm_recurrence_grouped_plain)
    from xumx_slicq_torch.kernels.analysis_gather import gather_flat_plain
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly_plain

    t = SliCQT(device=DEVICE, **MEL12)
    g = torch.Generator().manual_seed(0)
    flat = torch.randn((2, 5, t.raw_len), generator=g, dtype=torch.complex64)
    tab = t.synth_table
    assert torch.equal(kernel_ops.synth_assembly(flat, tab.idx, tab.w_re, tab.w_im, tab.unrot),
                       synth_assembly_plain(flat, tab))
    X = torch.randn((2, 5, t.nh), generator=g, dtype=torch.complex64)
    at = t.analysis_table
    assert torch.equal(kernel_ops.analysis_gather(X, at.entries, at.w), gather_flat_plain(X, at.entries, at.w))
    layout = t.layout(1, 2, 5)
    x = torch.randn(layout.size, generator=g, dtype=torch.complex64)
    v = torch.rand(4 * layout.size, generator=g)
    tables = k2._device_tables(layout, torch.device("cpu"))
    y, partials, maxima = kernel_ops.wiener_em_grouped(x, v, tables["buckets"], tables["items1"],
                                                       tables["items2"], k2.layout_ints(layout))
    assert torch.equal(y, k2.wiener_em_grouped_plain(x, v, layout))
    assert partials.shape == (tables["items1"].shape[0], 16) and maxima.shape == (len(layout.shapes),)
    rl = RecurrenceLayout([1, 3], [7, 4], 2, 2)
    xp = torch.randn(rl.xp_size, generator=g)
    w = torch.randn(rl.w_size, generator=g) * 0.3
    items, smem = _device_plan(rl, torch.device("cpu"))
    h = kernel_ops.lstm_recurrence(xp, w, items, smem, *layout_args(rl))
    h2, c = kernel_ops.lstm_recurrence_cell(xp, w, items, smem, *layout_args(rl))
    ref_h, ref_c = lstm_recurrence_grouped_plain(xp, w, rl, cell=True)
    assert torch.equal(h, ref_h) and torch.equal(h2, ref_h) and torch.equal(c, ref_c)


def test_opcheck_on_cpu():
    """torch.library.opcheck (schema, fake implementation, autograd
    registration) on each op's CPU implementation."""
    from xumx_slicq_torch.kernels.lstm_recurrence import RecurrenceLayout, _device_plan, layout_args

    t = SliCQT(device=DEVICE, **MEL12)
    g = torch.Generator().manual_seed(1)
    tab = t.synth_table
    flat = torch.randn((2, 3, t.raw_len), generator=g, dtype=torch.complex64)
    torch.library.opcheck(kernel_ops.synth_assembly, (flat, tab.idx, tab.w_re, tab.w_im, tab.unrot))
    at = t.analysis_table
    torch.library.opcheck(kernel_ops.analysis_gather,
                          (torch.randn((2, 3, t.nh), generator=g, dtype=torch.complex64), at.entries, at.w))
    layout = t.layout(1, 2, 3)
    tables = k2._device_tables(layout, torch.device("cpu"))
    x = torch.randn(layout.size, generator=g, dtype=torch.complex64)
    v = torch.rand(4 * layout.size, generator=g)
    torch.library.opcheck(kernel_ops.wiener_em_grouped, (x, v, tables["buckets"], tables["items1"],
                                                         tables["items2"], k2.layout_ints(layout)))
    rl = RecurrenceLayout([2], [5], 1, 2)
    items, smem = _device_plan(rl, torch.device("cpu"))
    args = (torch.randn(rl.xp_size, generator=g), torch.randn(rl.w_size, generator=g) * 0.3, items, smem,
            *layout_args(rl))
    torch.library.opcheck(kernel_ops.lstm_recurrence, args)
    torch.library.opcheck(kernel_ops.lstm_recurrence_cell, args)


def test_export_cli_help_and_needs_a_card(cdae_export, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        export_main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, out, _ = cdae_export
    with pytest.raises(RuntimeError, match="cuda"):
        export_main(["--model-path", str(d), "--output-dir", str(tmp_path / "x"), "--chunk-lens", str(CHUNK)])
    with pytest.raises(RuntimeError, match="cuda"):
        ExportedSeparator(out, device="cuda")
