"""Model export: torch.export artifacts of the whole chunk pipeline.

Port of xumx_slicq_tpu/export.py, whose StableHLO artifacts serialize the
entire chunk pipeline (sliCQT -> mask model -> Wiener-EM or mix-phase ->
inverse sliCQT) with the weights inside, one artifact per chunk length
(static shapes). Here each artifact is a `torch.export` program saved with
`torch.export.save`:

    export_dir/
      manifest.json      the model's args, batch, chunk list, format, device
      chunk_<len>.pt2    one ExportedProgram per chunk length

The hand-written kernels are opaque registered ops (kernels/ops.py): the
exported graph holds one `xumx_slicq::analysis_gather` node (K3), one
`xumx_slicq::synth_assembly` node (K1), one `xumx_slicq::cdae_folded`
node for the CDAE (K4, four launches), one
`xumx_slicq::wiener_em_grouped` node for the offline model (K2) and three
`xumx_slicq::lstm_recurrence` nodes for the LSTM (K5), never their plain
versions unrolled into ATen ops. An artifact exported on the card runs the
kernels of this checkout on the card when loaded in a fresh process
(`ExportedSeparator` imports kernels.ops first); one exported on the CPU
runs the plain versions on the CPU.
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .kernels import ops as kernel_ops
from .kernels.analysis_gather import analysis_gather
from .kernels import cdae_conv
from .kernels.lstm_recurrence import lstm_recurrence
from .kernels.synth_assembly import synth_assembly
from .kernels.wiener_em import wiener_em
from .separator import Separator, load_manifest

FORMAT = "torch.export"


class ChunkPipeline(nn.Module):
    """One chunk through the Separator's pipeline with its inference weights
    (BatchNorm folded for the CDAE, packed W_hh for the LSTM): (B, 2, chunk_len)
    audio -> (4, B, 2, chunk_len) estimates, what `Separator._chunk_fn`
    computes. The transform and the model are held outside the module's
    registered state, so an exported program keeps as constants only the
    tensors the pipeline reads."""

    def __init__(self, slicqt, model, chunk_len: int, prepared=None):
        super().__init__()
        self.parts = (slicqt, model.eval(), model.inference_weights() if prepared is None else prepared)
        self.chunk_len = int(chunk_len)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        slicqt, model, prepared = self.parts
        X = slicqt.forward(audio)
        Y, _ = model.apply(X, prepared)
        est = slicqt.backward([y.reshape((-1,) + y.shape[2:]) for y in Y], self.chunk_len)
        return est.reshape(4, -1, est.shape[1], self.chunk_len)


def build_chunk_fn(slicqt, model, chunk_len: int, prepared=None) -> ChunkPipeline:
    """The chunk pipeline of `model` on `slicqt` at one chunk length, over
    `prepared` (`model.inference_weights()` when None)."""
    return ChunkPipeline(slicqt, model, chunk_len, prepared)


def expected_ops(model) -> dict:
    """The op nodes an exported chunk pipeline of `model` must hold."""
    return dict(synth_assembly=1, analysis_gather=1, cdae_folded=0 if model.lstm else 1,
                wiener_em_grouped=0 if model.realtime else 1, lstm_recurrence=3 if model.lstm else 0,
                lstm_recurrence_cell=0)


# each op's launch counters: one a kernel, one a layer for K4
_COUNTERS = dict(synth_assembly=(synth_assembly,), analysis_gather=(analysis_gather,),
                 cdae_folded=tuple(cdae_conv.counters.values()), wiener_em_grouped=(wiener_em,),
                 lstm_recurrence=(lstm_recurrence,))


def export_chunk(fn: ChunkPipeline, batch: int, device) -> torch.export.ExportedProgram:
    """torch.export of one chunk pipeline at (batch, 2, chunk_len). On the
    card a real call runs first: it builds and loads every kernel library
    (raising if one cannot be), checks that each kernel of the path
    launched, and fills the kernels' table caches, so the trace reads them
    as device constants. Raises unless the graph holds exactly the
    expected `xumx_slicq::` op nodes."""
    audio = torch.zeros((batch, 2, fn.chunk_len), dtype=torch.float32, device=device)
    model = fn.parts[1]
    want = expected_ops(model)
    with torch.no_grad():
        if audio.device.type == "cuda":
            before = {k: [c.launches for c in cs] for k, cs in _COUNTERS.items()}
            fn(audio)
            torch.cuda.synchronize(audio.device)
            for k, cs in _COUNTERS.items():
                if want[k] and any(c.launches == n for c, n in zip(cs, before[k])):
                    raise RuntimeError(f"export: kernel {k} did not launch on the card")
        ep = torch.export.export(fn, (audio,), strict=False)
    got = kernel_ops.graph_op_counts(ep.graph)
    if got != want:
        raise RuntimeError(f"export: the graph holds {got} xumx_slicq op nodes, expected {want}")
    return ep


def export_model(model_path: str, output_dir: str, chunk_lens=(44100, 441000, 2621440), batch: int = 1,
                 device="cuda"):
    """Export the model in `model_path` as one artifact per chunk length into
    `output_dir`, with a manifest.json; returns the manifest."""
    device = resolve_device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    sep = Separator.load(model_path=model_path, device=device, chunk_size=None)
    args = load_manifest(Path(model_path))["args"]

    exported = []
    for clen in chunk_lens:
        t0 = time.time()
        ep = export_chunk(build_chunk_fn(sep.slicqt, sep.model, clen, sep._prepared), batch, device)
        out = output_dir / f"chunk_{clen}.pt2"
        torch.export.save(ep, out)
        seconds = time.time() - t0
        nbytes = out.stat().st_size
        exported.append({"chunk_len": int(clen), "file": out.name, "bytes": nbytes, "seconds": seconds,
                         "ops": kernel_ops.graph_op_counts(ep.graph)})
        print(f"exported chunk_len={clen}: {nbytes / 1e6:.1f} MB in {seconds:.1f} s")

    meta = {"args": args, "batch": batch, "chunks": exported, "format": FORMAT, "device": device.type}
    with open(output_dir / "manifest.json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class ExportedSeparator:
    """Run exported artifacts (chunk-bucketed) like a Separator, on the
    device they were exported for."""

    sources = Separator.sources

    def __init__(self, export_dir: str, device=None):
        self.dir = Path(export_dir)
        with open(self.dir / "manifest.json") as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{export_dir}: format {self.meta.get('format')!r}, expected {FORMAT!r}")
        self.device = resolve_device(device or self.meta["device"])
        if self.device.type != self.meta["device"]:
            raise ValueError(f"{export_dir} was exported for {self.meta['device']}, not {self.device.type}")
        self.sample_rate = self.meta["args"].get("sample_rate", 44100.0)
        self.batch = self.meta["batch"]
        self.chunk_lens = sorted(c["chunk_len"] for c in self.meta["chunks"])
        self._fns = {}

    def program(self, chunk_len: int) -> torch.export.ExportedProgram:
        """The ExportedProgram of one chunk length, loaded afresh."""
        fname = next(c["file"] for c in self.meta["chunks"] if c["chunk_len"] == chunk_len)
        return torch.export.load(self.dir / fname)

    def _fn(self, chunk_len: int):
        if chunk_len not in self._fns:
            self._fns[chunk_len] = self.program(chunk_len).module()
        return self._fns[chunk_len]

    @torch.no_grad()
    def __call__(self, audio: np.ndarray) -> np.ndarray:
        B, C, N = audio.shape
        if B != self.batch:
            raise ValueError(f"the artifacts take batch {self.batch}, got {B}")
        # pick the smallest bucket >= N, else tile the largest
        chunk = next((c for c in self.chunk_lens if c >= N), self.chunk_lens[-1])
        outs = []
        pos = 0
        while pos < N:
            hi = min(pos + chunk, N)
            a = np.zeros((B, C, chunk), np.float32)
            a[..., : hi - pos] = audio[..., pos:hi]
            est = self._fn(chunk)(torch.from_numpy(a).to(self.device))
            outs.append(est[..., : hi - pos].cpu().numpy())
            pos = hi
        return np.concatenate(outs, axis=-1)

    to_dict = staticmethod(Separator.to_dict)


def export_main(argv=None):
    parser = argparse.ArgumentParser(description="xumx-sliCQ PyTorch export (torch.export)")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--chunk-lens", type=int, nargs="+", default=[44100, 441000, 2621440])
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device the artifacts run on (the kernels on cuda, their plain versions on cpu)")
    args = parser.parse_args(argv)
    return export_model(args.model_path, args.output_dir, tuple(args.chunk_lens), batch=args.batch,
                        device=args.device)


if __name__ == "__main__":
    export_main()
