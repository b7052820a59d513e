// K4: the folded CDAE's four layers over every bucket and target, one
// launch a layer.
//
// Replaces the JAX package's BN-folded CDAE forward of each bucket
// (xumx_slicq_tpu/models/cdae.py: _enc1_frames 150-173, the folded layers of
// _single_target_cdae 204-240, _dec2_ola 112-147, the whitening at 251) and
// the mask product of xumx_slicq_tpu/models/unmix.py:146-152. Each layer is
// an implicit GEMM per (bucket, target):
//
//   out[row, col] = act(bias[col] + sum_r A[row, r] * W[r, col])
//
// with A gathered from the layer's input through a table of reduction
// steps: entry r = {delta, df, dk} reads in[base(row) + delta] when the
// row's input coordinates (fr + df, kr + dk) lie inside (FIN, KIN), else 0.
//
//   enc1: rows (b, f, k) of (B, F-fphi+1, K1), cols 50 channels, r = (c, d, t)
//         of the (fphi, T) kernel at stride T/2 over the S*T time axis; A is
//         the whitened |X| ((|X| + mean_f) * scale_f) of the packed complex
//         mixture, read on load; realtime shifts kr by the causal pad T-1.
//   enc2: rows (b, f, k) of (B, F1-fphi+1, K1-3), cols 51, r = (i, d, t), a
//         valid (fphi, 4) conv.
//   dec1: the (fphi, 4) transposed conv in gather form: r = (i, d, t) reads
//         (f - d, k - t).
//   dec2: the (fphi, T) transposed conv at stride T/2 over half slices: row
//         (b, f, m) is output samples [m*T/2, (m+1)*T/2) of frequency f, col
//         (c, t') one of them; each sample sums frame m at kernel offset t'
//         and frame m-1 at offset T/2 + t' (r = (o, d, e), e = 0/1), so every
//         output gathers its two frames: no atomics. The epilogue adds
//         dec2_b, takes the sigmoid and writes the mask and mask * |X| into
//         the packed (targets, B, C, F, S, T) buffers that K2 reads.
//
// Weights are packed once per model (kernels/cdae_conv.py) as one [R_pad][ldw]
// matrix a (layer, bucket, target), zero past R and past the layer's
// columns. The work table holds one item a (bucket, target, row tile, col
// tile), the heaviest reductions first, so the F = 86 bucket's tiles start
// first and the short ones fill the last wave.
//
// Bound: operations (fp32 FMA on the CUDA cores; about 162 GMAC a default
// chunk batch of 4 at bark-262, against ~4 GB of activations). Design, simple
// first: a block computes a BM x BN tile; warps split the columns (8 each),
// lanes the rows (TM each, 32 apart), so a warp reads each weight as a
// broadcast from shared memory and each activation once per 8 columns. The
// reduction walks chunks of RC steps: each thread gathers its rows' next
// chunk into registers while the block computes the current one from shared
// memory. Sums are fp32 FMAs in a fixed order (no TF32, no atomics). The
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int RC = 16;  // reduction steps a chunk

// Fields of a plan row (one per layer and bucket), int64; kernels/cdae_conv.py
// writes them in this order.
enum {
    P_IN_OFF, P_OUT_OFF, P_W_OFF, P_BIAS_OFF, P_RTAB_OFF, P_R_PAD, P_LDW, P_N, P_ROWS, P_FOKO, P_KO,
    P_KSTRIDE, P_KPAD, P_FIN, P_KIN, P_IN_BSTRIDE, P_IN_GSTRIDE, P_OUT_BSTRIDE, P_OUT_GSTRIDE,
    P_OUT_CSTRIDE, P_HOP, P_WHITE_OFF, P_X_OFF, P_FIELDS
};
static_assert(P_FIELDS == 23, "plan row layout");

enum { MODE_CONV = 0, MODE_ENC1 = 1, MODE_DEC2 = 2 };

template <int WM, int WN, int TM, int MODE>
__global__ void __launch_bounds__(32 * WM * WN, 2)
cdae_layer_kernel(const float* __restrict__ in, const float* __restrict__ wt, const int64_t* __restrict__ plan,
                  const int4* __restrict__ items, const int4* __restrict__ rtab, float* __restrict__ out,
                  float* __restrict__ mags, const float2* __restrict__ mix) {
    constexpr int NT = 32 * WM * WN;      // threads
    constexpr int BM = 32 * WM * TM;      // rows a tile
    constexpr int BN = 8 * WN;            // columns a tile
    constexpr int GR = BM / NT;           // rows each thread gathers
    constexpr int WL = RC * BN / NT;      // weights each thread stages a chunk
    constexpr int LD = BN + 1;            // dec2's staged output row (padded: no bank conflicts)
    constexpr int AS = (MODE == MODE_DEC2 && BM * LD > RC * BM) ? BM * LD : RC * BM;
    static_assert(BM % NT == 0 && (RC * BN) % NT == 0, "tile shape");
    __shared__ __align__(16) float As[AS];
    __shared__ __align__(16) float Ws[RC * BN];

    const int4 item = items[blockIdx.x];
    const int64_t* p = plan + (int64_t)item.x * P_FIELDS;
    const int g = item.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % WM, wn = warp / WM;
    const int rows = (int)p[P_ROWS], foko = (int)p[P_FOKO], ko = (int)p[P_KO];
    const int fin = (int)p[P_FIN], kin = (int)p[P_KIN];
    const int ldw = (int)p[P_LDW], n_cols = (int)p[P_N];
    const int chunks = (int)p[P_R_PAD] / RC;
    const int row0 = item.z * BM, col0 = item.w * BN;
    const float* W = wt + p[P_W_OFF] + (int64_t)g * p[P_R_PAD] * ldw + col0;
    const int4* rt = rtab + p[P_RTAB_OFF];
    const float* white = wt + p[P_WHITE_OFF];

    // the input coordinates and base address of each row this thread gathers
    int64_t base[GR];
    int fr[GR], kr[GR];
#pragma unroll
    for (int q = 0; q < GR; ++q) {
        const int row = row0 + tid + NT * q;
        if (row < rows) {
            const int b = row / foko, rem = row - b * foko, f = rem / ko, k = rem - f * ko;
            fr[q] = f;
            kr[q] = k * (int)p[P_KSTRIDE] - (int)p[P_KPAD];
            base[q] = p[P_IN_OFF] + b * p[P_IN_BSTRIDE] + g * p[P_IN_GSTRIDE] + (int64_t)f * kin + kr[q];
        } else {                           // past the last row: every step reads nothing
            fr[q] = -(1 << 30);
            kr[q] = 0;
            base[q] = 0;
        }
    }

    float ga[GR][RC], gw[WL];
    auto gather = [&](int c) {
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
            const int4 e = __ldg(rt + c * RC + rr);
#pragma unroll
            for (int q = 0; q < GR; ++q) {
                float v = 0.f;
                if ((unsigned)(fr[q] + e.y) < (unsigned)fin && (unsigned)(kr[q] + e.z) < (unsigned)kin) {
                    if constexpr (MODE == MODE_ENC1) {
                        const float2 x = __ldg(reinterpret_cast<const float2*>(in) + base[q] + e.x);
                        const int f = fr[q] + e.y;
                        v = (sqrtf(x.x * x.x + x.y * x.y) + __ldg(white + f)) * __ldg(white + fin + f);
                    } else {
                        v = __ldg(in + base[q] + e.x);
                    }
                }
                ga[q][rr] = v;
            }
        }
#pragma unroll
        for (int j = 0; j < WL; ++j) {
            const int e = tid + NT * j;
            gw[j] = __ldg(W + (int64_t)(c * RC + e / BN) * ldw + e % BN);
        }
    };

    float acc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    gather(0);
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
        for (int rr = 0; rr < RC; ++rr)
#pragma unroll
            for (int q = 0; q < GR; ++q) As[rr * BM + tid + NT * q] = ga[q][rr];
#pragma unroll
        for (int j = 0; j < WL; ++j) Ws[tid + NT * j] = gw[j];
        __syncthreads();
        if (c + 1 < chunks) gather(c + 1);   // in flight while this chunk is computed
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
            float a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[rr * BM + wm * 32 * TM + lane + 32 * i];
            const float4 w0 = *reinterpret_cast<const float4*>(&Ws[rr * BN + wn * 8]);
            const float4 w1 = *reinterpret_cast<const float4*>(&Ws[rr * BN + wn * 8 + 4]);
            const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
    }

    if constexpr (MODE != MODE_DEC2) {
        // bias + ReLU into the (B, targets * N, FO, KO) activation; lanes on consecutive rows
        const float* bias = wt + p[P_BIAS_OFF] + g * n_cols;
        const int64_t cstride = p[P_OUT_CSTRIDE];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int row = row0 + wm * 32 * TM + lane + 32 * i;
            if (row >= rows) continue;
            const int b = row / foko, rem = row - b * foko;
            const int64_t o = p[P_OUT_OFF] + b * p[P_OUT_BSTRIDE] + g * p[P_OUT_GSTRIDE] + rem;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = col0 + wn * 8 + j;
                if (col < n_cols) out[o + col * cstride] = fmaxf(acc[i][j] + __ldg(bias + col), 0.f);
            }
        }
    } else {
        // dec2: stage the tile, then write it with consecutive threads on consecutive samples
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) As[(wm * 32 * TM + lane + 32 * i) * LD + wn * 8 + j] = acc[i][j];
        __syncthreads();
        const int hop = (int)p[P_HOP];
        const int channels = n_cols / hop;
        const float* bias = wt + p[P_BIAS_OFF] + g * channels;
        const int64_t bstride = p[P_OUT_BSTRIDE], cstride = p[P_OUT_CSTRIDE];
        const int64_t out0 = p[P_OUT_OFF] + g * p[P_OUT_GSTRIDE], x0 = p[P_X_OFF];
        for (int e = tid; e < BM * BN; e += NT) {
            const int rl = e / BN, cl = e - rl * BN;
            const int row = row0 + rl, col = col0 + cl;
            if (row >= rows || col >= n_cols) continue;
            const int b = row / foko, rem = row - b * foko, c = col / hop, t = col - c * hop;
            const int64_t pos = b * bstride + c * cstride + (int64_t)rem * hop + t;
            const float y = As[rl * LD + cl] + __ldg(bias + c);
            const float m = 1.f / (1.f + expf(-y));
            const float2 x = __ldg(mix + x0 + pos);
            out[out0 + pos] = m;
            mags[out0 + pos] = m * sqrtf(x.x * x.x + x.y * x.y);
        }
    }
}

template <int WM, int WN, int TM, int MODE>
int launch(const void* in, const void* wt, const void* plan, const void* items, int32_t n_items, const void* rtab,
           void* out, void* mags, const void* mix, void* stream) {
    if (n_items > 0) {
        cdae_layer_kernel<WM, WN, TM, MODE><<<(unsigned int)n_items, 32 * WM * WN, 0, (cudaStream_t)stream>>>(
            (const float*)in, (const float*)wt, (const int64_t*)plan, (const int4*)items, (const int4*)rtab,
            (float*)out, (float*)mags, (const float2*)mix);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Tiles: the channel layers 224 rows x 56 columns (7 warps, 7 rows x 8
// columns a thread), dec2 512 half-slice rows x 16 samples (8 warps, 4 x 8).
extern "C" int cdae_enc1(const void* x, const void* wt, const void* plan, const void* items, int32_t n_items,
                         const void* rtab, void* h1, void* stream) {
    return launch<1, 7, 7, MODE_ENC1>(x, wt, plan, items, n_items, rtab, h1, nullptr, nullptr, stream);
}

extern "C" int cdae_enc2(const void* h1, const void* wt, const void* plan, const void* items, int32_t n_items,
                         const void* rtab, void* h2, void* stream) {
    return launch<1, 7, 7, MODE_CONV>(h1, wt, plan, items, n_items, rtab, h2, nullptr, nullptr, stream);
}

extern "C" int cdae_dec1(const void* h2, const void* wt, const void* plan, const void* items, int32_t n_items,
                         const void* rtab, void* h3, void* stream) {
    return launch<1, 7, 7, MODE_CONV>(h2, wt, plan, items, n_items, rtab, h3, nullptr, nullptr, stream);
}

extern "C" int cdae_dec2(const void* h3, const void* wt, const void* plan, const void* items, int32_t n_items,
                         const void* rtab, void* masks, void* mags, const void* x, void* stream) {
    return launch<4, 2, 4, MODE_DEC2>(h3, wt, plan, items, n_items, rtab, masks, mags, x, stream);
}
