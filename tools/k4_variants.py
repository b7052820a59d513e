#!/usr/bin/env python3
"""K4 (csrc/cdae_conv.cu) built from several sources and timed layer by
layer in one process on one NVIDIA GPU.

    python3 tools/k4_variants.py [LABEL=SOURCE.cu ...] [--derived NAME ...] [--sass DIR] [--out FILE]

Each SOURCE is a whole cdae_conv.cu with this checkout's C interface and
tables (this checkout's, or a variant kept under a directory git ignores).
Every build is timed at the main path's layout (bark-262, a chunk batch of 4
default chunks from SliCQT.forward of 0.1-RMS noise, offline, BatchNorm and
whitening drawn off their defaults): each layer's ms between CUDA events
(median of 10 calls after 2), on this checkout's work tables. Each result
is compared with this checkout's K4 (max |a - b| of the masks; a variant
that leaves work out is expected to differ) and printed as one JSON line
with ptxas's registers and spills and, with --sass DIR, the SASS listing in
DIR and each kernel's instruction, HMMA (tensor-core mma) and LDGSTS
(cp.async) counts. --derived builds variants of this checkout's source
from the text edits in DERIVED: work left out (the line gathers of enc2,
dec1 and dec2, the weight copies, dec2's stores or its |X| loads, two of
the three products), other tile shapes, and the probe.
A build that exports `cdae_debug(buffer)` (the probe: clock64 per phase of
each warp, summed in a device array that the call copies out and zeroes)
also gets each layer's share of cycles in setup, waiting at the ring,
issuing copies, computing and the epilogue.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CHUNK, BATCH = 2621440, 4
LAYERS = ("enc1", "enc2", "dec1", "dec2")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sass_counts(sass: str) -> dict:
    """Per function of a cuobjdump -sass listing: instructions, HMMA, LDGSTS."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            args = re.search(r"cdae_layer_kernelI((?:Li\d+E)+)E", m.group(1))
            name = "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">" if args else m.group(1)
            counts[name] = dict(instructions=0, HMMA=0, LDGSTS=0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            counts[name]["instructions"] += 1
            if m.group(1) in counts[name]:
                counts[name][m.group(1)] += 1
    return counts


# Variants derived from this checkout's csrc/cdae_conv.cu by text edits (each (old, new), old must occur):
# the probe, work left out to see what it costs, and other tile shapes.
_PROBE = [
    ("enum { MODE_CONV = 0, MODE_ENC1 = 1, MODE_DEC2 = 2 };",
     "enum { MODE_CONV = 0, MODE_ENC1 = 1, MODE_DEC2 = 2 };\n__device__ unsigned long long k4_dbg[3][8];"),
    ("    const int4 item = items[blockIdx.x];",
     "    long long t_entry = clock64(), t_mark = t_entry;\n    unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    auto mark = [&](int i) { const long long t = clock64(); ph[i] += t - t_mark; t_mark = t; };\n"
     "    const int4 item = items[blockIdx.x];"),
    ("    for (int ct = 0, it = 0; ct < n_ct; ++ct) {", "    mark(0);\n    for (int ct = 0, it = 0; ct < n_ct; ++ct) {"),
    ("            if (it + STAGES - 1 < total) issue_next((it + STAGES - 1) % STAGES);\n            else cp_async_commit();",
     "            mark(1);\n            if (it + STAGES - 1 < total) issue_next((it + STAGES - 1) % STAGES);\n"
     "            else cp_async_commit();\n            mark(2);"),
    ("   // columns past ldw are dropped\n            }\n", "   // columns past ldw are dropped\n            }\n            mark(3);\n"),
    ("        epilogue(ct);", "        epilogue(ct);\n        mark(4);"),
    ("    cp_async_wait<0>();\n}",
     "    cp_async_wait<0>();\n    ph[5] = clock64() - t_entry;\n    ph[6] = total;\n    ph[7] = 1;\n"
     "    if (lane == 0)\n        for (int i = 0; i < 8; ++i) atomicAdd(&k4_dbg[MODE][i], ph[i]);\n}"),
    ("}  // namespace",
     "}  // namespace\n\nextern \"C\" int cdae_debug(void* host) {\n    static unsigned long long zero[3 * 8] = {};\n"
     "    cudaError_t err = cudaMemcpyFromSymbol(host, k4_dbg, sizeof(zero));\n"
     "    if (err == cudaSuccess) err = cudaMemcpyToSymbol(k4_dbg, zero, sizeof(zero));\n    return (int)err;\n}"),
]
DERIVED = {
    "probe": _PROBE,
    "dec2_no_stores": [("*reinterpret_cast<float2*>(mo + pos) = make_float2(m0, m1);",
                        "if (m0 == 12345.f) *reinterpret_cast<float2*>(mo + pos) = make_float2(m0, m1);"),
                       ("*reinterpret_cast<float2*>(go + pos) = make_float2(",
                        "if (m1 == 12345.f) *reinterpret_cast<float2*>(go + pos) = make_float2(")],
    "dec2_no_x_loads": [("x[j] = __ldg(reinterpret_cast<const float4*>(xo + rpos + cpos[j]));",
                         "x[j] = make_float4(1.f, 0.f, 1.f, 0.f);")],
    "no_line_gather": [("cp_async_zfill<4>(d + LW - 1, src + (ok ? o + LW - 1 : 0), ok);", "(void)ok;"),
                       ("cp_async_zfill<4>(d + j, src + (okj ? o + j : 0), okj);", "(void)okj;")],
    "no_weight_copies": [("            if (gi < gn && q < pieces)\n                cp_async16(", "            if (false)\n                cp_async16(")],
    "one_product": [("            mma_tf32(acc[mt][j], alo[mt], b[j].x, b[j].y);\n"
                     "            mma_tf32(acc[mt][j], ahi[mt], b[j].z, b[j].w);\n", "")],
    "conv_4warps": [("launch<MODE_CONV, 8, 2, 7, 16, 3, 0, 2>", "launch<MODE_CONV, 4, 4, 7, 16, 3, 0, 2>")],
    "enc1_ring4": [("launch<MODE_ENC1, 8, 1, 7, 8, 3, 0, 2, 2>", "launch<MODE_ENC1, 8, 1, 7, 8, 4, 0, 2, 2>")],
    "dec2_2blocks": [("launch<MODE_DEC2, 4, 2, 8, 8, 3, 13, 3>", "launch<MODE_DEC2, 4, 2, 8, 8, 3, 13, 2>")],
}


def derive(name: str, out_dir: Path) -> str:
    """This checkout's csrc/cdae_conv.cu with DERIVED[name]'s edits, written to out_dir."""
    text = (ROOT / "xumx_slicq_torch" / "csrc" / "cdae_conv.cu").read_text()
    for old, new in DERIVED[name]:
        if old not in text:
            raise ValueError(f"variant {name}: the source has no {old!r}")
        text = text.replace(old, new)
    path = out_dir / f"{name}.cu"
    path.write_text(text)
    return str(path)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sources", nargs="*", help="LABEL=path of a cdae_conv.cu")
    ap.add_argument("--derived", nargs="*", default=[], choices=sorted(DERIVED),
                    help="also build these variants of this checkout's source")
    ap.add_argument("--sass", help="directory for each build's SASS listing")
    ap.add_argument("--out", help="write every result to this JSON file too")
    args = ap.parse_args()
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from xumx_slicq_torch.kernels import build, cdae_conv
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT

    results = []

    def emit(**fields):
        print(json.dumps(fields), flush=True)
        results.append(fields)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(phase="card", nvidia_smi=smi)
    out_dir = ROOT / "build" / "k4_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    labels = [s.split("=", 1) for s in args.sources] + [(name, derive(name, out_dir)) for name in args.derived]
    procs = {}
    for label, src in labels:                   # every build at once
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out_dir / f"lib{label}.so"), src]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for label, proc in procs.items():
        logs[label] = proc.communicate()[0]
        if proc.returncode:
            emit(variant=label, error=f"nvcc failed: {logs[label][-3000:]}")
    labels = [(label, src) for label, src in labels if procs[label].returncode == 0]

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    slicqt = SliCQT(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        X = slicqt.forward(torch.randn((BATCH, 2, CHUNK), generator=g, device=dev) * 0.1)
    layout = X.layout
    model = cs.perturbed(Unmix(slicqt.block_shapes(1, 2, 2 * 44100), seed=0, device=dev))
    weights = model.inference_weights()
    plan, items, rtab, sizes = cdae_conv._device_tables(layout, weights.arch, False, dev)
    with torch.inference_mode():
        _, ref = cdae_conv.cdae_folded(X.packed, weights, layout, False)
    h13 = torch.empty(sizes[4], device=dev)
    h2 = torch.empty(sizes[5], device=dev)
    masks = torch.empty(weights.arch.targets * layout.size, device=dev)
    mags = torch.empty_like(masks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    firsts = np.cumsum([0] + sizes[:4])
    for label, src in labels:
        lib = ctypes.CDLL(str(out_dir / f"lib{label}.so"))
        calls = []
        for li, (name, s, d) in enumerate(zip(LAYERS, (X.packed, h13, h2, h13), (h13, h2, h13, masks))):
            fn = getattr(lib, f"cdae_{name}")
            extra = [mags.data_ptr(), X.packed.data_ptr()] if name == "dec2" else []
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 3 + [ctypes.c_void_p] * (3 + len(extra))
            fn.restype = ctypes.c_int
            argv = (s.data_ptr(), weights.w.data_ptr(), plan.data_ptr(), items[int(firsts[li])].data_ptr(),
                    sizes[li], sizes[6 + li], sizes[10 + li], rtab.data_ptr(), d.data_ptr(), *extra, stream)
            calls.append(lambda fn=fn, argv=argv: cs.check(fn(*argv) == 0, f"{label}: a launch failed"))
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        runs = {k: [] for k in LAYERS}
        for _ in range(12):
            for i, call in enumerate(calls):
                events[i].record()
                call()
            events[4].record()
            torch.cuda.synchronize()
            for i, k in enumerate(LAYERS):
                runs[k].append(events[i].elapsed_time(events[i + 1]))
        usage = [x.strip() for x in logs[label].splitlines() if "registers" in x or "spill" in x]
        phases = {}
        if hasattr(lib, "cdae_debug"):     # a probe build: its cycles per phase, one layer at a time
            buf = (ctypes.c_ulonglong * 24)()
            lib.cdae_debug.argtypes = [ctypes.c_void_p]
            lib.cdae_debug(ctypes.addressof(buf))
            for li, (name, call) in enumerate(zip(LAYERS, calls)):
                call()
                torch.cuda.synchronize()
                cs.check(lib.cdae_debug(ctypes.addressof(buf)) == 0, f"{label}: reading the probe failed")
                mode = {"enc1": 1, "dec2": 2}.get(name, 0)
                v = list(buf[8 * mode: 8 * mode + 8])
                phases[name] = dict(zip(("setup", "wait", "issue", "compute", "epilogue"), (x / v[5] for x in v[:5])),
                                    cycles_per_warp=v[5] / v[7], iterations_per_warp=v[6] / v[7], warps=v[7])
        fields = dict(variant=label, source=src, ms={k: float(np.median(v[2:])) for k, v in runs.items()},
                      four_ms=sum(float(np.median(v[2:])) for v in runs.values()),
                      masks_max_abs_diff=float((masks - ref).abs().max()), ptxas=usage, phases=phases)
        if args.sass:
            cuobjdump = str(Path(build._nvcc()).parent / "cuobjdump")
            sass = subprocess.run([cuobjdump, "-sass", str(out_dir / f"lib{label}.so")], capture_output=True,
                                  text=True, check=True).stdout
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            (Path(args.sass) / f"k4_sass_{label}.txt").write_text(sass)
            fields["sass"] = sass_counts(sass)
        emit(**fields)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
