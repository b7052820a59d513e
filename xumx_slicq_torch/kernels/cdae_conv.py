"""K4: the BN-folded CDAE of every bucket and target, four launches a forward.

Replaces the JAX package's folded CDAE forward of each bucket
(xumx_slicq_tpu/models/cdae.py: `_enc1_frames` 150-173, the folded layers
of `_single_target_cdae` 204-240, `_dec2_ola` 112-147, the whitening at
251) and the mask product of xumx_slicq_tpu/models/unmix.py:146-152, which
the port ran as cuDNN convs, ~8 launches a bucket (models/cdae.py). Given
the packed complex mixture X (ops/packed.py) and the packed folded weights
of a model (`pack_weights`, built once per model), it computes for every
bucket, in one launch a layer (csrc/cdae_conv.cu):

    enc1  whitened |X| -> conv (fphi, T) at stride T/2, + bias, ReLU
    enc2  conv (fphi, 4), + bias, ReLU
    dec1  transposed conv (fphi, 4), + bias, ReLU
    dec2  transposed conv (fphi, T) at stride T/2, + dec2_b, sigmoid
          -> the masks, and mask * |X| into the packed magnitudes K2 reads

returning (mags, masks), each a packed (targets, B, C, F, S, T) buffer in
X's layout. The realtime model pads enc1 causally by T-1 and keeps the
first S*T samples of dec2, as models/cdae.py does. Each layer's launches
are counted in `counters[layer].launches`.

The weights' packing: for each (bucket, layer, target) one [R_pad][ldw]
float32 matrix, row r a reduction step, column a layer output, zero past
R and past the layer's columns, and its split copy for the kernel
(`_split_matrices`: each weight as TF32 high and low parts, in the order
the tensor cores' fragments read them), then the biases and the
whitening, all in one buffer (`_offsets`). The work tables
(`work_tables`, one set per layout and architecture, cached per device)
hold one row of ints per
(layer, bucket) (`PLAN_FIELDS`, the order csrc/cdae_conv.cu reads), one
entry {delta, df, dk, 0} per reduction step, and one item per (bucket,
target, row tile; enc1: two targets), the heaviest first (steps times
column tiles: the block walks every column tile of its rows).

The kernels run on the tensor cores in the 3xTF32 form (each fp32 operand
split into a TF32 high part and remainder, three products summed in
fp32), which keeps fp32 accuracy; the tensor cores' fp32 sums round
otherwise than the CUDA cores', which leaves the masks ~2e-6 from the
plain version at the main path's layout.

`plain_layers` is the plain version of one bucket's four layers, and
the folded forward of `SlicedCDAE` (models/cdae.py) runs it;
`cdae_folded_plain` runs it bucket by bucket on the weights unpacked from
the buffer (`unpack_weights`), in fp32. The latter is the registered op `xumx_slicq::cdae_folded`'s CPU
implementation (kernels/ops.py); the CUDA one is `launch`. K4 has no
backward: folded weights are eval-only, and the wrapper refuses an input
that requires a gradient.
"""

import ctypes
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..device import device_cache
from ..ops.packed import BucketLayout
from . import build

RC = {"enc1": 8, "enc2": 16, "dec1": 16, "dec2": 8}   # reduction steps a kernel's chunk (R is padded to them)
ENC1_TILE = (128, 56)            # rows x columns a target of a column tile: enc1
ENC1_TARGETS = 2                 # targets an enc1 block sums at once: they share its gathered |X|
CONV_TILE = (256, 56)            # rows x columns of a column tile: enc2, dec1
DEC2_TILE = (128, 64)            # half-slice rows x samples of a column tile: dec2
DEC2_RESIDENT = 104              # dec2's reduction steps a block keeps while it walks its column tiles
TF2 = 4                          # enc2's and dec1's time kernel: the steps of one line gather (csrc/cdae_conv.cu)
LAYERS = ("enc1", "enc2", "dec1", "dec2")
PLAN_FIELDS = ("in_off", "out_off", "w_off", "bias_off", "rtab_off", "r_pad", "ldw", "n", "rows", "foko",
               "ko", "kstride", "kpad", "fin", "kin", "in_bstride", "in_gstride", "out_bstride", "out_gstride",
               "out_cstride", "hop", "white_off", "x_off")
_INVALID = 1 << 29               # df of a padded reduction step: reads nothing


@dataclass(frozen=True)
class CdaeArch:
    """What fixes the packed weights: each bucket's (C, F, T, fphi), fphi
    its frequency kernel height, the number of targets the module holds
    and the hidden sizes and time filter."""

    buckets: Tuple[Tuple[int, int, int, int], ...]
    targets: int = 4
    h1: int = 50
    h2: int = 51
    tf2: int = 4

    def ints(self) -> List[int]:
        """The architecture as the int list the registered op takes."""
        return [self.targets, self.h1, self.h2, self.tf2] + [d for b in self.buckets for d in b]

    @staticmethod
    def of_ints(v: Sequence[int]) -> "CdaeArch":
        v = list(v)
        return CdaeArch(tuple(tuple(v[i: i + 4]) for i in range(4, len(v), 4)), *v[:4])


@dataclass(frozen=True)
class CdaeWeights:
    """A model's folded CDAE weights packed for K4 (`pack_weights`): one
    float32 buffer on the model's device, read only."""

    w: torch.Tensor
    arch: CdaeArch


def _layer_dims(arch: CdaeArch, C: int, T: int, fphi: int) -> Dict[str, Tuple[int, int]]:
    """(R, N) of each layer of one bucket: reduction length and output
    columns per target."""
    hop = T // 2
    return {
        "enc1": (C * fphi * T, arch.h1),
        "enc2": (arch.h1 * fphi * arch.tf2, arch.h2),
        "dec1": (arch.h2 * fphi * arch.tf2, arch.h1),
        "dec2": (arch.h1 * fphi * 2, C * hop),
    }


def _ceil(a: int, b: int) -> int:
    return -(-a // b) * b


def _offsets(arch: CdaeArch) -> List[dict]:
    """Per bucket, where each part lies in the packed weight buffer: per
    layer (offset, R, R_pad, N, ldw, split offset) of the targets' fp32
    [R_pad][ldw] matrices (R_pad a multiple of RC[layer], ldw of 8: the kernel's
    n8 tiles) and of their split copies (`_split_matrices`, 2 R_pad ldw
    floats a target, each at a multiple of 4 floats, for 16-byte copies),
    then the biases of enc1, enc2, dec1 and dec2 and the whitening (mean
    then scale, F each). The last entry's "end" is the buffer's size."""
    out, off = [], 0
    n = arch.targets
    for C, F, T, fphi in arch.buckets:
        if T % 2:
            raise ValueError(f"cdae_conv: a bucket's T must be even (hop T/2), got {T}")
        e = {"layers": {}}
        for name, (R, N) in _layer_dims(arch, C, T, fphi).items():
            r_pad, ldw = _ceil(R, RC[name]), _ceil(N, 8)
            off = _ceil(off, 4)
            e["layers"][name] = (off, R, r_pad, N, ldw, off + n * r_pad * ldw)
            off += 3 * n * r_pad * ldw
        for name, size in (("enc1_b", n * arch.h1), ("enc2_b", n * arch.h2), ("dec1_b", n * arch.h1),
                           ("dec2_b", n * C), ("white", 2 * F)):
            e[name] = off
            off += size
        e["end"] = off
        out.append(e)
    return out


def _as_matrices(name: str, w: torch.Tensor, arch: CdaeArch, C: int, T: int, fphi: int) -> torch.Tensor:
    """A layer's folded torch-layout weight -> (targets, R, N): row r the
    reduction step the kernel walks, column the layer's output."""
    n, h1, h2, tf2 = arch.targets, arch.h1, arch.h2, arch.tf2
    hop = T // 2
    if name == "enc1":       # OIHW (n h1, C, fphi, T): r = (c, d, t)
        return w.reshape(n, h1, C * fphi * T).transpose(1, 2)
    if name == "enc2":       # OIHW (n h2, h1, fphi, tf2): r = (i, d, t)
        return w.reshape(n, h2, h1 * fphi * tf2).transpose(1, 2)
    if name == "dec1":       # IOHW (n h2, h1, fphi, tf2): r = (i, d, t), column o
        return w.reshape(n, h2, h1, fphi, tf2).permute(0, 1, 3, 4, 2).reshape(n, h2 * fphi * tf2, h1)
    # dec2, IOHW (n h1, C, fphi, T) with T = (e, t'): r = (o, d, e), column (c, t')
    return w.reshape(n, h1, C, fphi, 2, hop).permute(0, 1, 3, 4, 2, 5).reshape(n, h1 * fphi * 2, C * hop)


def _from_matrices(name: str, m: torch.Tensor, arch: CdaeArch, C: int, T: int, fphi: int) -> torch.Tensor:
    """The inverse of `_as_matrices`: (targets, R, N) -> the torch layout."""
    n, h1, h2, tf2 = arch.targets, arch.h1, arch.h2, arch.tf2
    hop = T // 2
    if name == "enc1":
        return m.transpose(1, 2).reshape(n * h1, C, fphi, T)
    if name == "enc2":
        return m.transpose(1, 2).reshape(n * h2, h1, fphi, tf2)
    if name == "dec1":
        return m.reshape(n, h2, fphi, tf2, h1).permute(0, 1, 4, 2, 3).reshape(n * h2, h1, fphi, tf2)
    return m.reshape(n, h1, fphi, 2, C, hop).permute(0, 1, 4, 2, 3, 5).reshape(n * h1, C, fphi, T)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as PTX's cvt.rna.tf32.f32 for finite x, by bit operations on an
    int32 view."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_matrices(m: torch.Tensor) -> torch.Tensor:
    """(targets, R_pad, ldw) fp32 -> the kernel's split copy (targets,
    R_pad / 8, ldw, 4, 4): for each 8 reduction steps, column n and t < 4,
    (hi[t], hi[t + 4], lo[t], lo[t + 4]) of column n, hi = tf32_round(w)
    and lo = tf32_round(w - hi): one lane's two m16n8k8 B fragments
    (steps t and t + 4), high and low, in one 16-byte load."""
    n, r_pad, ldw = m.shape
    hi = tf32_round(m)
    lo = tf32_round(m - hi)
    h, l = hi.view(n, r_pad // 8, 2, 4, ldw), lo.view(n, r_pad // 8, 2, 4, ldw)
    return torch.stack((h[:, :, 0], h[:, :, 1], l[:, :, 0], l[:, :, 1]), -1).permute(0, 1, 3, 2, 4)


def pack_weights(folded: Sequence[Dict[str, torch.Tensor]], arch: CdaeArch) -> CdaeWeights:
    """Every bucket's folded weights (`SlicedCDAE.fold_batchnorm`) in K4's
    packed buffer, on their device: the fp32 matrices (the plain version
    reads them) and their split copies (the kernel reads those). Folded
    weights are eval-only: the buffer carries no gradient."""
    offs = _offsets(arch)
    with torch.no_grad():
        w = torch.zeros(offs[-1]["end"] if offs else 0, dtype=torch.float32, device=folded[0]["enc1_w"].device)
        for (C, F, T, fphi), o, p in zip(arch.buckets, offs, folded):
            for name, (off, R, r_pad, N, ldw, koff) in o["layers"].items():
                size = arch.targets * r_pad * ldw
                dst = w[off: off + size].view(arch.targets, r_pad, ldw)
                dst[:, :R, :N] = _as_matrices(name, p[f"{name}_w"].float(), arch, C, T, fphi)
                w[koff: koff + 2 * size] = _split_matrices(dst).reshape(-1)
            for name in ("enc1_b", "enc2_b", "dec1_b", "dec2_b"):
                b = p[name].reshape(-1)
                w[o[name]: o[name] + b.numel()] = b
            w[o["white"]: o["white"] + F] = p["input_mean"]
            w[o["white"] + F: o["white"] + 2 * F] = p["input_scale"]
    return CdaeWeights(w, arch)


def unpack_weights(w: torch.Tensor, arch: CdaeArch) -> List[Dict[str, torch.Tensor]]:
    """The packed buffer back to per-bucket dicts of `fold_batchnorm`'s
    names and torch layouts (views where the layout allows)."""
    out = []
    for (C, F, T, fphi), o in zip(arch.buckets, _offsets(arch)):
        p = {}
        for name, (off, R, r_pad, N, ldw, _) in o["layers"].items():
            m = w[off: off + arch.targets * r_pad * ldw].view(arch.targets, r_pad, ldw)[:, :R, :N]
            p[f"{name}_w"] = _from_matrices(name, m, arch, C, T, fphi)
        for name, size in (("enc1_b", arch.h1), ("enc2_b", arch.h2), ("dec1_b", arch.h1), ("dec2_b", C)):
            p[name] = w[o[name]: o[name] + arch.targets * size]
        p["input_mean"] = w[o["white"]: o["white"] + F]
        p["input_scale"] = w[o["white"] + F: o["white"] + 2 * F]
        out.append(p)
    return out


def plain_layers(p: Dict[str, torch.Tensor], realtime: bool, targets: int, S: int,
                 T: int) -> Tuple[Callable[[torch.Tensor], torch.Tensor], ...]:
    """One bucket's folded CDAE (`fold_batchnorm`'s dict `p`) in plain
    PyTorch, fp32, as K4's four layers, each a function of the one before:
    enc1 takes the (B, C, F, S, T) magnitude, dec2 returns the masks
    (targets, B, C, F, S, T)."""
    hop = T // 2

    def enc1(x_mag):
        B, C, F = x_mag.shape[:3]
        x = (x_mag + p["input_mean"][None, None, :, None, None]) * p["input_scale"][None, None, :, None, None]
        x = x.reshape(B, C, F, S * T)
        if realtime:
            x = Fn.pad(x, (T - 1, 0))
        return torch.relu(Fn.conv2d(x, p["enc1_w"], p["enc1_b"], stride=(1, hop)))

    def enc2(h):
        return torch.relu(Fn.conv2d(h, p["enc2_w"], p["enc2_b"], groups=targets))

    def dec1(h):
        return torch.relu(Fn.conv_transpose2d(h, p["dec1_w"], p["dec1_b"], groups=targets))

    def dec2(h):
        y = Fn.conv_transpose2d(h, p["dec2_w"], p["dec2_b"], stride=(1, hop), groups=targets)
        mask = torch.sigmoid(y[..., : S * T])
        return mask.reshape(h.shape[0], targets, -1, y.shape[2], S, T).transpose(0, 1)

    return enc1, enc2, dec1, dec2


def folded_bucket_plain(x_mag: torch.Tensor, p: Dict[str, torch.Tensor], realtime: bool,
                        targets: int) -> torch.Tensor:
    """One bucket's folded CDAE in plain PyTorch: (B, C, F, S, T) magnitude
    -> masks (targets, B, C, F, S, T)."""
    h = x_mag
    for layer in plain_layers(p, realtime, targets, *x_mag.shape[3:]):
        h = layer(h)
    return h


def cdae_folded_plain(X: torch.Tensor, w: torch.Tensor, layout: BucketLayout, arch: CdaeArch,
                      realtime: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain PyTorch, bucket by bucket: the packed complex
    mixture (layout.size,) -> (mags, masks), packed (targets * layout.size,)
    float32 each."""
    n = arch.targets
    masks = torch.empty(n * layout.size, dtype=torch.float32, device=X.device)
    mags = torch.empty_like(masks)
    for xb, p, mb, gb in zip(layout.split(X), unpack_weights(w, arch), layout.split(masks, n),
                             layout.split(mags, n)):
        xm = torch.abs(xb)
        mb.copy_(folded_bucket_plain(xm, p, realtime, n))
        torch.mul(mb, xm[None], out=gb)
    return mags, masks


def _activation_sizes(layout: BucketLayout, arch: CdaeArch, realtime: bool):
    """Per bucket the (F1, K1, F2, K2) of the activations, and the offsets of
    h1 (also h3, which overwrites it) and h2 in their scratch buffers."""
    dims, h1_off, h2_off, s1, s2 = [], [], [], 0, 0
    n = arch.targets
    for (B, C, F, S, T), (_, _, _, fphi) in zip(layout.shapes, arch.buckets):
        F1, K1 = F - fphi + 1, 2 * S if realtime else 2 * S - 1
        F2, K2 = F1 - fphi + 1, K1 - arch.tf2 + 1
        if F2 < 1 or K2 < 1:
            raise ValueError(f"cdae_conv: bucket {(B, C, F, S, T)} is too small for the CDAE's kernels")
        dims.append((F1, K1, F2, K2))
        h1_off.append(s1)
        h2_off.append(s2)
        s1 += B * n * arch.h1 * F1 * K1
        s2 += B * n * arch.h2 * F2 * K2
    return dims, h1_off, h2_off, s1, s2


TILES = {"enc1": ENC1_TILE, "enc2": CONV_TILE, "dec1": CONV_TILE, "dec2": DEC2_TILE}
LINE_WIDTH = {"enc2": TF2, "dec1": TF2, "dec2": 2}   # steps a line of the kernels' line gather


def _line_length(ko: int, name: str) -> int:
    """The line length of a layer's line gather for rows of ko time steps a
    (b, f) (csrc/cdae_conv.cu): a row tile's rows, plus LINE_WIDTH - 1 for
    each run of rows in one input line it touches, rounded up to 16 (mod
    32) floats, so that lanes reading two lines hit other banks."""
    bm, lw = TILES[name][0], LINE_WIDTH[name]
    n = bm + (lw - 1) * ((bm - 1) // ko + 2)
    return n + (16 - n) % 32


def work_tables(layout: BucketLayout, arch: CdaeArch, realtime: bool):
    """K4's tables for one layout: (plan (4 * buckets, PLAN_FIELDS) int64,
    items (n_items, 4) int32, rtab (steps, 4) int32, sizes), sizes being
    the items of each layer (4 ints), the scratch sizes of h1 and h2, the
    longest step table (R_pad) of each layer (4 ints: the kernel keeps an
    item's table in shared memory), then the line length of enc2's, dec1's
    and dec2's gathers (`_line_length`) and enc1's largest F (its whitening
    in shared memory) (4 ints)."""
    if tuple((C, F, T) for _, C, F, _, T in layout.shapes) != tuple(b[:3] for b in arch.buckets):
        raise ValueError("cdae_conv: the layout's buckets differ from the weights' architecture")
    if arch.tf2 != TF2:
        raise ValueError(f"cdae_conv: the kernels' enc2 and dec1 gather groups of {TF2} time steps, got {arch.tf2}")
    n, h1, h2, tf2 = arch.targets, arch.h1, arch.h2, arch.tf2
    woffs = _offsets(arch)
    dims, h1_off, h2_off, s1, s2 = _activation_sizes(layout, arch, realtime)
    nb = len(layout.shapes)
    plan = np.zeros((4 * nb, len(PLAN_FIELDS)), np.int64)
    rtabs, rtab_off = [], 0
    items = [[] for _ in LAYERS]
    for k, ((B, C, F, S, T), xoff, wo, (F1, K1, F2, K2), (_, _, _, fphi)) in enumerate(
            zip(layout.shapes, layout.offsets, woffs, dims, arch.buckets)):
        hop = T // 2
        steps = {        # per layer: the reduction's (extent, delta stride, df sign, dk sign) axes
            "enc1": ((C, F * S * T, 0, 0), (fphi, S * T, 1, 0), (T, 1, 0, 1)),
            "enc2": ((h1, F1 * K1, 0, 0), (fphi, K1, 1, 0), (tf2, 1, 0, 1)),
            "dec1": ((h2, F2 * K2, 0, 0), (fphi, -K2, -1, 0), (tf2, -1, 0, -1)),
            "dec2": ((h1, F1 * K1, 0, 0), (fphi, -K1, -1, 0), (2, -1, 0, -1)),
        }
        rows = {"enc1": (F1, K1), "enc2": (F2, K2), "dec1": (F1, K1), "dec2": (F, 2 * S)}
        inputs = {       # (in_off, fin, kin, in_bstride, in_gstride)
            "enc1": (xoff, F, S * T, C * F * S * T, 0),
            "enc2": (h1_off[k], F1, K1, n * h1 * F1 * K1, h1 * F1 * K1),
            "dec1": (h2_off[k], F2, K2, n * h2 * F2 * K2, h2 * F2 * K2),
            "dec2": (h1_off[k], F1, K1, n * h1 * F1 * K1, h1 * F1 * K1),
        }
        outputs = {      # (out_off, out_bstride, out_gstride, out_cstride)
            "enc1": (h1_off[k], n * h1 * F1 * K1, h1 * F1 * K1, F1 * K1),
            "enc2": (h2_off[k], n * h2 * F2 * K2, h2 * F2 * K2, F2 * K2),
            "dec1": (h1_off[k], n * h1 * F1 * K1, h1 * F1 * K1, F1 * K1),
            "dec2": (n * xoff, C * F * S * T, B * C * F * S * T, F * S * T),
        }
        for li, name in enumerate(LAYERS):
            _, R, r_pad, N, ldw, w_off = wo["layers"][name]
            grids = np.meshgrid(*[np.arange(a[0]) for a in steps[name]], indexing="ij")
            e = np.zeros((r_pad, 4), np.int64)
            e[R:, 1] = _INVALID
            for axis, (_, stride, sf, sk) in zip(grids, steps[name]):
                e[:R, 0] += axis.ravel() * stride
                e[:R, 1] += axis.ravel() * sf
                e[:R, 2] += axis.ravel() * sk
            rtabs.append(e)
            FO, KO = rows[name]
            in_off, fin, kin, in_b, in_g = inputs[name]
            out_off, out_b, out_g, out_c = outputs[name]
            bias = wo[("enc1_b", "enc2_b", "dec1_b", "dec2_b")[li]]
            row = dict(in_off=in_off, out_off=out_off, w_off=w_off, bias_off=bias, rtab_off=rtab_off,
                       r_pad=r_pad, ldw=ldw, n=N, rows=B * FO * KO, foko=FO * KO, ko=KO,
                       kstride=hop if name == "enc1" else 1, kpad=T - 1 if name == "enc1" and realtime else 0,
                       fin=fin, kin=kin, in_bstride=in_b, in_gstride=in_g, out_bstride=out_b, out_gstride=out_g,
                       out_cstride=out_c, hop=hop, white_off=wo["white"], x_off=xoff)
            plan[li * nb + k] = [row[f] for f in PLAN_FIELDS]
            rtab_off += r_pad
            bm, bn = TILES[name]
            cost = r_pad * -(-ldw // bn)        # steps times column tiles: a block walks all its column tiles
            gt = ENC1_TARGETS if name == "enc1" else 1
            for rt in range(-(-(B * FO * KO) // bm)):     # the targets of a row tile together: they share X
                for g in range(0, n, gt):
                    items[li].append((cost, li * nb + k, g, rt, min(gt, n - g)))
    ordered = []
    for layer_items in items:       # heaviest items first (stable): the longest tiles start first
        layer_items.sort(key=lambda it: -it[0])
        ordered.append(np.asarray([it[1:] for it in layer_items], np.int32).reshape(-1, 4))
    rtab = np.concatenate(rtabs)
    if max(s1, s2, layout.size, np.abs(rtab).max()) >= 2 ** 31:
        raise ValueError("cdae_conv: the activations are too large for the kernel's 32-bit offsets")
    max_steps = [int(plan[li * nb: (li + 1) * nb, PLAN_FIELDS.index("r_pad")].max()) for li in range(len(LAYERS))]
    lines = [max(_line_length(int(ko), name) for ko in plan[li * nb: (li + 1) * nb, PLAN_FIELDS.index("ko")])
             if name in LINE_WIDTH else max(F for _, _, F, _, _ in layout.shapes) for li, name in enumerate(LAYERS)]
    sizes = [len(it) for it in ordered] + [s1, s2] + max_steps + lines
    return plan, np.concatenate(ordered), rtab.astype(np.int32), sizes



@device_cache
def _device_tables(layout: BucketLayout, arch: CdaeArch, realtime: bool, device: torch.device):
    """K4's tables for a layout on a device, built once (outside a trace)."""
    plan, items, rtab, sizes = work_tables(layout, arch, realtime)
    return (torch.from_numpy(plan).to(device), torch.from_numpy(items).to(device),
            torch.from_numpy(rtab).to(device), sizes)


def launch(X: torch.Tensor, w: torch.Tensor, plan: torch.Tensor, items: torch.Tensor, rtab: torch.Tensor,
           layout: BucketLayout, targets: int, sizes: Sequence[int], events=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's four launches on CUDA tensors (the registered op's CUDA
    implementation, kernels/ops.py), each counted in `counters`.
    Returns (mags, masks); h1/h3 and h2 are scratch of this call. events:
    five CUDA events to record around the launches (before each, after the
    last), for timing each layer."""
    dev = X.device
    for t, dtype in ((X, torch.complex64), (w, torch.float32), (plan, torch.int64), (items, torch.int32),
                     (rtab, torch.int32)):
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"cdae_folded: need contiguous {dtype} on {dev}, got {t.dtype} on {t.device}")
    if X.numel() != layout.size or plan.shape[1:] != (len(PLAN_FIELDS),) or items.shape[1:] != (4,) \
            or rtab.shape[1:] != (4,) or len(sizes) != 14 or items.shape[0] != sum(sizes[:4]):
        raise ValueError("cdae_folded: tables or mixture do not fit the layout")
    if w.data_ptr() % 16:
        raise ValueError("cdae_folded: the packed weights must start on 16 bytes (the kernel's 16-byte copies)")
    n_items, (s1, s2), max_steps, lines = sizes[:4], sizes[4:6], sizes[6:10], sizes[10:14]
    h13 = torch.empty(s1, dtype=torch.float32, device=dev)
    h2 = torch.empty(s2, dtype=torch.float32, device=dev)
    masks = torch.empty(targets * layout.size, dtype=torch.float32, device=dev)
    mags = torch.empty_like(masks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    conv_args = (ctypes.c_void_p,) * 4 + (ctypes.c_int32,) * 3 + (ctypes.c_void_p,) * 3
    first = 0
    for i, (name, count, steps, line, src, dst) in enumerate(zip(LAYERS, n_items, max_steps, lines, (X, h13, h2, h13),
                                                                 (h13, h2, h13, masks))):
        if events is not None:
            events[i].record()
        extra = (mags.data_ptr(), X.data_ptr()) if name == "dec2" else ()
        argtypes = conv_args[:-1] + (ctypes.c_void_p,) * 2 + conv_args[-1:] if extra else conv_args
        fn = build.function("cdae_conv", f"cdae_{name}", argtypes)
        rc = fn(src.data_ptr(), w.data_ptr(), plan.data_ptr(), items[first].data_ptr() if count else items.data_ptr(),
                count, steps, line, rtab.data_ptr(), dst.data_ptr(), *extra, stream)
        if rc != 0:
            raise RuntimeError(f"cdae_conv: the {name} launch failed with cudaError {rc}")
        counters[name].launches += 1
        first += count
    if events is not None:
        events[4].record()
    return mags, masks


def _check(X: torch.Tensor, weights: CdaeWeights, layout: BucketLayout):
    if X.dtype != torch.complex64 or X.dim() != 1 or X.numel() != layout.size or not X.is_contiguous():
        raise ValueError(f"cdae_folded: need the packed contiguous complex64 mixture ({layout.size},), "
                         f"got {X.dtype} {tuple(X.shape)}")
    if X.requires_grad or weights.w.requires_grad:
        raise ValueError("cdae_folded: K4 runs folded (eval-only) weights and takes no gradient")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cdae_folded: unsupported device {X.device}")
    if weights.w.device != X.device or not weights.w.is_contiguous():
        raise ValueError(f"cdae_folded: the packed weights must be contiguous on {X.device}")


def cdae_folded(X: torch.Tensor, weights: CdaeWeights, layout: BucketLayout,
                realtime: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on a CUDA tensor (four launches), its plain version on a CPU tensor.

    X: the packed complex64 mixture of `layout`; weights: `pack_weights` of
    a model whose buckets are the layout's. Returns (mags, masks), packed
    (targets * layout.size,) float32 in X's layout."""
    from . import ops

    _check(X, weights, layout)
    plan, items, rtab, sizes = _device_tables(layout, weights.arch, realtime, X.device)
    return ops.cdae_folded(X, weights.w, plan, items, rtab, [d for s in layout.shapes for d in s],
                           weights.arch.ints(), int(realtime), sizes)


counters = {name: SimpleNamespace(launches=0) for name in LAYERS}     # one launch count a layer
