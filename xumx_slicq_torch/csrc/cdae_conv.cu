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
//         mixture; realtime shifts kr by the causal pad T-1.
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
// Weights are packed once per model (kernels/cdae_conv.py) as one fp32
// [R_pad][ldw] matrix a (layer, bucket, target), zero past R and past the
// layer's columns (R_pad a multiple of the layer's chunk, ldw of 8), which
// the plain version reads, and its split copy, which the kernel reads: per
// 8 steps, column n and t < 4 the 16 bytes (hi[t], hi[t+4], lo[t], lo[t+4])
// that a lane's m16n8k8 B fragments need, hi = rna_tf32(w), lo =
// rna_tf32(w - hi). The work table holds one item a (bucket, target, row
// tile), the longest reductions first, so the F = 86 bucket's tiles start
// first and the short ones fill the last wave, and a row tile's targets
// next to each other (enc1 and dec2 read the same mixture); a block walks
// every column tile of its item.
//
// Bound: operations (about 162 GMAC a default chunk batch of 4 at bark-262,
// against ~5 GB of activations). Design:
//   * Tensor cores in the 3xTF32 form: mma.sync m16n8k8 on TF32 operands,
//     each fp32 operand x split into hi = rna_tf32(x) and lo = rna_tf32(x -
//     hi); a step adds lo*hi, hi*lo, then hi*hi into fp32 accumulators,
//     which keeps fp32 accuracy (CUTLASS's OpMultiplyAddFastF32). The
//     weights are split when they are packed; the activations as their
//     fragments are loaded from shared memory (rna by integer operations:
//     add half an ulp of TF32 and drop the 13 low bits, which the tensor
//     cores ignore anyway; the compiler's cvt.rna costs twice as many).
//   * Operands through shared memory in a ring of STAGES chunks filled by
//     cp.async: the gather is 4-byte copies (8 for enc1's complex pair),
//     zero-filled (src-size 0) where a step falls outside the input; the
//     weights are 16-byte copies. STAGES - 1 chunks are in flight
//     while one is computed. An item's step table is copied to shared memory
//     first (read from L2 at every chunk it put an L2 round trip in front of
//     every gather: L1 is small beside the tiles). A lane loads its split B
//     fragments with one 16-byte load.
//   * enc2, dec1, dec2: a group of LW steps (the (fphi, 4) kernel's t =
//     0..3 in enc2 and dec1, LW = 4; dec2's two frames e = 0, 1, LW = 2)
//     reads, for consecutive rows of one (b, f), a sliding window of one
//     input line. So a chunk holds KC / LW lines a row tile, each row
//     copying one element (a row that starts a tile or a new (b, f) also the
//     LW - 1 before it), and step t of row r is line[pos(r) + t] (dec1 and
//     dec2, which read k - t: line[pos(r) + LW - 1 - t]): 1 / LW of the
//     copies of a gather a (row, step). Lanes reading one line meet on one
//     address or fall on other banks; lines are 16 (mod 32) floats long, so
//     dec2's lanes reading two lines do too.
//   * enc1 copies the raw complex pair (its rows are T/2 samples apart, so
//     consecutive threads take a row's consecutive steps) and forms (|x| +
//     mean_f) * scale_f as the fragment is built, from the same validity
//     rule as the gather, so that a step outside the input (the realtime
//     causal pad) contributes 0 and not the whitening of 0; the bucket's
//     whitening is in shared memory.
//   * dec2: a block owns every column of its row tile. Where the reduction
//     fits (R_pad <= RES chunks) the row tile's gathered lines stay resident
//     in shared memory while the block loops over its column tiles, so each
//     activation is gathered once a block. The epilogue writes masks and
//     magnitudes straight from the accumulators, two columns a lane (8-byte
//     stores: staging the tile in shared memory, or swapping halves between
//     lanes, for 16-byte stores measured slower), with each row's |X| loads
//     issued before its stores.
//   * Tiles: enc2, dec1 256 rows x 56 columns (8 warps of 32 x 56: the
//     50/51 channels in 7 n8 tiles); enc1 128 rows x 2 targets' 56 columns
//     (8 warps of 16 x 112: the targets share the gathered, whitened |X|,
//     so a block sums two of them at once); dec2 128 rows x 64 columns (4
//     warps of 32 x 64). Set by the F = 86 bucket (R = 1,000 in enc2 and
//     dec1, 16 columns in dec2: 2 n8 tiles, which dec2 computes alone) and
//     the wide dec2 buckets (T up to 292).
// Every sum has a fixed order (no atomics), so K4 is bit-equal from run to
// run. The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

// Fields of a plan row (one per layer and bucket), int64; kernels/cdae_conv.py
// writes them in this order.
enum {
    P_IN_OFF, P_OUT_OFF, P_W_OFF, P_BIAS_OFF, P_RTAB_OFF, P_R_PAD, P_LDW, P_N, P_ROWS, P_FOKO, P_KO,
    P_KSTRIDE, P_KPAD, P_FIN, P_KIN, P_IN_BSTRIDE, P_IN_GSTRIDE, P_OUT_BSTRIDE, P_OUT_GSTRIDE,
    P_OUT_CSTRIDE, P_HOP, P_WHITE_OFF, P_X_OFF, P_FIELDS
};
static_assert(P_FIELDS == 23, "plan row layout");

enum { MODE_CONV = 0, MODE_ENC1 = 1, MODE_DEC2 = 2 };

constexpr int TF2 = 4;   // enc2's and dec1's time kernel: one line of the conv gather (kernels/cdae_conv.py TF2)

// steps a line of the line gather: enc2 and dec1 a group of the time kernel's TF2 steps, dec2 the two
// half slices {e = 0, 1} of a frame; enc1 gathers (row, step) elements
template <int MODE>
constexpr int line_width() { return MODE == MODE_CONV ? TF2 : MODE == MODE_DEC2 ? 2 : 0; }

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// BYTES (4 or 8) from src into shared memory, or zeros (src not read) when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(BYTES),
                 "r"(valid ? BYTES : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + O(2^-22 |x|) for finite x: hi = cvt.rna.tf32.f32(x), and lo
// the same of x - hi with its 13 low bits left for the tensor core to drop
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One m16n8k8 step of a warp: MT x NJ tiles, three products each, small ones first.
// B: the split weight tile of this step, [col][t][hi(t), hi(t + 4), lo(t), lo(t + 4)].
template <int MT, int NJ, int NACC>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NACC][4], const uint32_t (&ahi)[MT][4],
                                         const uint32_t (&alo)[MT][4], const float* B, int gq, int tq) {
    uint4 b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = *reinterpret_cast<const uint4*>(B + (j * 8 + gq) * 16 + 4 * tq);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(acc[mt][j], alo[mt], b[j].x, b[j].y);
            mma_tf32(acc[mt][j], ahi[mt], b[j].z, b[j].w);
            mma_tf32(acc[mt][j], ahi[mt], b[j].x, b[j].y);
        }
}

// Shape of one layer's kernel: WARPS warps along the rows, each MT m16 tiles
// by NTILE n8 tiles a target, for GT targets at once (enc1, whose gathered A
// the targets share); KC steps a chunk, STAGES chunks in the ring; RES chunks
// of resident A (dec2); MINB blocks an SM (launch bounds).
template <int MODE, int WARPS, int MT, int NTILE, int KC, int STAGES, int RES, int MINB, int GT>
struct Tile {
    static constexpr int NT = 32 * WARPS;                              // threads
    static constexpr int BM = 16 * MT * WARPS;                         // rows a tile
    static constexpr int BN = 8 * NTILE;                               // columns a column tile
    static constexpr int KB = KC / 8;                                  // m16n8k8 steps a chunk
    using AT = typename std::conditional<MODE == MODE_ENC1, float2, float>::type;
    // enc1: a step's row of its A tile of complex pairs, = 4 (mod 16) float2: no bank conflicts
    static constexpr int LDA = BM + 4;
    // enc2, dec1, dec2: a chunk is KC / LW lines of LW steps each, of the launch's line length (a
    // tile's rows plus LW - 1 a run of rows in one input line); the ring is sized at launch
    static constexpr int LW = line_width<MODE>();
    static constexpr int ASLOTS = RES > STAGES ? RES : STAGES;
    static constexpr int WSLOT = KB * GT * BN * 16;                    // floats of a chunk's split weights
    static constexpr size_t A_BYTES = LW ? 0 : (size_t)ASLOTS * KC * LDA * sizeof(AT);
    static constexpr size_t W_BYTES = (size_t)STAGES * WSLOT * sizeof(float);
    static constexpr size_t I_BYTES = MODE == MODE_ENC1 ? (size_t)BM * sizeof(int4) : 0;
    static constexpr size_t SMEM = A_BYTES + W_BYTES + I_BYTES;   // + the item's step table + conv's lines
    // line: the line length; enc1's largest F (its whitening, (mean, scale) a frequency)
    static size_t smem(int max_steps, int line) {
        return SMEM + (size_t)max_steps * sizeof(int2) + (LW ? (size_t)ASLOTS * (KC / LW) * line * 4 : (size_t)line * 8);
    }
    static_assert((MODE == MODE_ENC1 ? BM % (NT / KC) : BM % NT) == 0 && KC % 8 == 0 && NT % KC == 0 &&
                  STAGES >= 2 && (LW == 0 || KC % LW == 0), "tile shape");
};

template <int MODE, int WARPS, int MT, int NTILE, int KC, int STAGES, int RES, int MINB, int GT>
__global__ void __launch_bounds__(32 * WARPS, MINB)
cdae_layer_kernel(const float* __restrict__ in, const float* __restrict__ wt, const int64_t* __restrict__ plan,
                  const int4* __restrict__ items, const int4* __restrict__ rtab, float* __restrict__ out,
                  float* __restrict__ mags, const float2* __restrict__ mix, int max_steps, int line) {
    using TL = Tile<MODE, WARPS, MT, NTILE, KC, STAGES, RES, MINB, GT>;
    using AT = typename TL::AT;
    constexpr int NJT = GT * NTILE;                   // n8 tiles a warp sums
    constexpr int NT = TL::NT, BM = TL::BM, BN = TL::BN, KB = TL::KB, LDA = TL::LDA;
    constexpr int LW = TL::LW;
    const int LDL = line, ASTAGE = LW ? KC / LW * line : KC * LDA;   // AT elements of a chunk
    constexpr int WSLOT = TL::WSLOT;
    extern __shared__ __align__(16) unsigned char smem[];
    float* Ws = reinterpret_cast<float*>(smem + TL::A_BYTES);
    int4* Is = reinterpret_cast<int4*>(smem + TL::A_BYTES + TL::W_BYTES);
    int2* Rs = reinterpret_cast<int2*>(smem + TL::SMEM);
    AT* As = LW ? reinterpret_cast<AT*>(Rs + max_steps) : reinterpret_cast<AT*>(smem);
    float2* Wh = reinterpret_cast<float2*>(Rs + max_steps);        // enc1: the bucket's whitening

    const int4 item = items[blockIdx.x];
    const int64_t* p = plan + (int64_t)item.x * P_FIELDS;
    const int g = item.y, gn = GT > 1 ? item.w : 1;   // the item's first target, and its targets
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3;          // the mma fragments' group and thread in group
    const int rows = (int)p[P_ROWS], foko = (int)p[P_FOKO], ko = (int)p[P_KO];
    const int fin = (int)p[P_FIN], kin = (int)p[P_KIN];
    const int ldw = (int)p[P_LDW], n_cols = (int)p[P_N];
    const int chunks = (int)p[P_R_PAD] / KC;
    const int n_ct = (ldw + BN - 1) / BN;
    const bool resident = MODE == MODE_DEC2 && n_ct > 1 && chunks <= RES;
    const int total = n_ct * chunks;
    const int row0 = item.z * BM;
    const int64_t wstride = p[P_R_PAD] * ldw * 2;    // a target's split weights
    const float* W = wt + p[P_W_OFF] + g * wstride;
    const AT* src = reinterpret_cast<const AT*>(in) + p[P_IN_OFF] + g * p[P_IN_GSTRIDE];

    // a row's input coordinates and offset: (offset, fr, kr), fr far out of range past the last row
    auto row_info = [&](int row) {
        if (row >= rows) return make_int3(0, -(1 << 30), 0);
        const int b = row / foko, rem = row - b * foko, f = rem / ko;
        const int kr = (rem - f * ko) * (int)p[P_KSTRIDE] - (int)p[P_KPAD];
        return make_int3((int)(b * p[P_IN_BSTRIDE]) + f * kin + kr, f, kr);
    };

    // the item's step table in shared memory, {delta, df | dk << 16} a step: its reads
    // stay off the gather's critical path (L1 is small beside the tiles)
    {
        const int4* rt = rtab + p[P_RTAB_OFF];
        const int steps = (int)p[P_R_PAD];
        for (int r = tid; r < steps; r += NT) {
            const int4 e = __ldg(rt + r);
            const int df = max(-32768, min(32767, e.y)), dk = max(-32768, min(32767, e.z));
            Rs[r] = make_int2(e.x, (int)(((unsigned)df & 0xFFFFu) | ((unsigned)dk << 16)));
        }
    }
    auto step = [&](int r, int& df, int& dk) {
        const int2 e = Rs[r];
        df = (e.y << 16) >> 16;
        dk = e.y >> 16;
        return e.x;
    };

    if constexpr (MODE == MODE_ENC1) {   // in shared memory: read a step of every fragment, it must not miss L1
        const float* white = wt + p[P_WHITE_OFF];
        for (int f = tid; f < fin; f += NT) Wh[f] = make_float2(__ldg(white + f), __ldg(white + fin + f));
    }
    // line gather: a line position a tile row, rows in one input line (one (b, f)) next to each other
    // and LW - 1 apart where a new line starts (a row whose k is 0), so that row r's steps t are
    // line[pos(r) + t] (dec1 and dec2, which read k - t: line[pos(r) + LW - 1 - t])
    auto line_pos = [&](int r) { return r + (LW - 1) * ((row0 + r) / ko - row0 / ko); };
    // conv, dec2: each thread gathers rows tid + NT q, all steps of a chunk
    constexpr int GR = MODE == MODE_ENC1 ? 1 : BM / NT;
    int3 gr[GR];
    int gpos[GR];
    bool gstart[GR];
    if constexpr (MODE != MODE_ENC1) {
#pragma unroll
        for (int q = 0; q < GR; ++q) {
            const int r = tid + NT * q;
            gr[q] = row_info(row0 + r);
            if constexpr (LW > 0) {
                gpos[q] = line_pos(r);
                gstart[q] = r == 0 || (row0 + r) % ko == 0;
            }
        }
    } else {               // enc1: the rows' coordinates in shared memory, read by the gather and the fragments
        for (int r = tid; r < BM; r += NT) {
            const int3 ri = row_info(row0 + r);
            Is[r] = make_int4(ri.x, ri.y, ri.z, 0);
        }
    }
    __syncthreads();

    // line gather: step 1's dk is +1 where a line's steps read k + t (enc2), -1 where they read k - t
    int df1, dk1;
    step(1, df1, dk1);
    const int aoff = dk1 > 0 ? 0 : 1 - LW;            // line element j is step t = j (enc2), LW - 1 - j

    // chunk c of column tile ct into ring slot `slot`: the gather (unless
    // resident and already there) and the split weights, as one cp.async group
    auto issue = [&](int ct, int c, int slot) {
        if (!resident || ct == 0) {
            AT* dst = As + (resident ? c : slot) * ASTAGE;
            if constexpr (LW > 0) {
                // each row copies its line's last element, a line's first row also its first LW - 1
#pragma unroll
                for (int l = 0; l < KC / LW; ++l) {
                    int df, dk;
                    const int delta = step(c * KC + LW * l, df, dk) + aoff;
#pragma unroll
                    for (int q = 0; q < GR; ++q) {
                        const bool fok = (unsigned)(gr[q].y + df) < (unsigned)fin;
                        const int k0 = gr[q].z + dk + aoff, o = gr[q].x + delta;
                        AT* d = dst + l * LDL + gpos[q];
                        const bool ok = fok && (unsigned)(k0 + LW - 1) < (unsigned)kin;
                        cp_async_zfill<4>(d + LW - 1, src + (ok ? o + LW - 1 : 0), ok);
                        if (gstart[q]) {
#pragma unroll
                            for (int j = 0; j < LW - 1; ++j) {
                                const bool okj = fok && (unsigned)(k0 + j) < (unsigned)kin;
                                cp_async_zfill<4>(d + j, src + (okj ? o + j : 0), okj);
                            }
                        }
                    }
                }
            } else {       // consecutive threads on a row's consecutive steps: coalesced along t
                constexpr int RPP = NT / KC;
                const int rr = tid % KC, r0 = tid / KC;
                int df, dk;
                const int delta = step(c * KC + rr, df, dk);
#pragma unroll 8
                for (int r = r0; r < BM; r += RPP) {
                    const int4 ri = Is[r];
                    const bool ok = (unsigned)(ri.y + df) < (unsigned)fin && (unsigned)(ri.z + dk) < (unsigned)kin;
                    cp_async_zfill<8>(dst + rr * LDA + r, src + (ok ? ri.x + delta : 0), ok);
                }
            }
        }
        // the split weights: per target, KB x (columns of this tile) x 64 bytes, contiguous per step
        // group; in shared memory [step group][target, column][16]
        const int col0 = ct * BN, pieces = 4 * min(BN, ldw - col0);
        float* wdst = Ws + slot * WSLOT;
#pragma unroll
        for (int i = 0; i < (GT * KB * BN * 4 + NT - 1) / NT; ++i) {
            const int e = tid + NT * i, gi = e / (KB * BN * 4), r = e - gi * (KB * BN * 4);
            const int kb = r / (BN * 4), q = r - kb * (BN * 4);
            if (gi < gn && q < pieces)
                cp_async16(wdst + (kb * GT + gi) * BN * 16 + 4 * q,
                           W + gi * wstride + ((int64_t)(c * KB + kb) * ldw + col0) * 16 + 4 * q);
        }
        cp_async_commit();
    };

    // line gather: the line positions of the fragment rows this thread reads (rows g and g + 8 of each
    // m16 tile), and where its steps t and t + 4 of an m16n8k8 step lie: line (t + 4 i) / LW, element
    // (t % LW, or LW - 1 - t % LW where the steps read k - t)
    int fpos[LW ? MT : 1][2], foff[2];
    if constexpr (LW > 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) fpos[mt][h] = line_pos(warp * 16 * MT + mt * 16 + gq + 8 * h);
#pragma unroll
        for (int i = 0; i < 2; ++i) foff[i] = (tq + 4 * i) / LW * LDL + (dk1 > 0 ? tq % LW : LW - 1 - tq % LW);
    }
    // enc1: the input coordinates of the fragment rows this thread reads
    int ffr[MODE == MODE_ENC1 ? MT : 1][2], fkr[MODE == MODE_ENC1 ? MT : 1][2];
    if constexpr (MODE == MODE_ENC1) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int4 ri = Is[warp * 16 * MT + mt * 16 + gq + 8 * h];
                ffr[mt][h] = ri.y;
                fkr[mt][h] = ri.z;
            }
    }

    float acc[MT][NJT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

    // the epilogue of column tile ct: bias and ReLU into the activation, or dec2's masks and magnitudes
    auto epilogue = [&](int ct) {
        if constexpr (MODE != MODE_DEC2) {
            // (B, targets * N, FO, KO): a warp's stores cover 8 consecutive rows of 4 columns
            const float* bias = wt + p[P_BIAS_OFF] + g * n_cols;
            const int64_t cstride = p[P_OUT_CSTRIDE], gstride = p[P_OUT_GSTRIDE];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + warp * 16 * MT + mt * 16 + gq + 8 * h;
                    if (row >= rows) continue;
                    const int b = row / foko, rem = row - b * foko;
                    float* o = out + p[P_OUT_OFF] + b * p[P_OUT_BSTRIDE] + g * gstride + rem;
#pragma unroll
                    for (int j = 0; j < NJT; ++j)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int gi = j / NTILE, col = ct * BN + (j % NTILE) * 8 + 2 * tq + e;
                            if (gi < gn && col < n_cols)
                                o[gi * gstride + col * cstride] =
                                    fmaxf(acc[mt][j][2 * h + e] + __ldg(bias + gi * n_cols + col), 0.f);
                        }
                }
        } else {
            // straight from the accumulators: a lane's two columns (2t, 2t + 1) of rows g and g + 8; a row's
            // |X| loads are issued together, before its stores
            const int hop = (int)p[P_HOP];
            const float* bias = wt + p[P_BIAS_OFF] + g * (n_cols / hop);
            const int64_t bstride = p[P_OUT_BSTRIDE], cstride = p[P_OUT_CSTRIDE];
            float* mo = out + p[P_OUT_OFF] + g * p[P_OUT_GSTRIDE];
            float* go = mags + p[P_OUT_OFF] + g * p[P_OUT_GSTRIDE];
            const float2* xo = mix + p[P_X_OFF];
            // two columns then lie in one channel, side by side (T/2 even)
            const bool vec = hop % 2 == 0 && ((uintptr_t)mo | (uintptr_t)go | (uintptr_t)xo) % 16 == 0;
            int64_t cpos[NTILE];
            float bj[NTILE];
#pragma unroll
            for (int j = 0; j < NTILE; ++j) {
                const int col = min(ct * BN + j * 8 + 2 * tq, n_cols - 2), c = col / hop;   // even where vec
                cpos[j] = c * cstride + (col - c * hop);
                bj[j] = __ldg(bias + c);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = row0 + warp * 16 * MT + mt * 16 + gq + 8 * h, rc = min(row, rows - 1);
                    const int b = rc / foko, rem = rc - b * foko;
                    const int64_t rpos = b * bstride + (int64_t)rem * hop;
                    if (vec) {
                        float4 x[NTILE];
#pragma unroll
                        for (int j = 0; j < NTILE; ++j) x[j] = __ldg(reinterpret_cast<const float4*>(xo + rpos + cpos[j]));
#pragma unroll
                        for (int j = 0; j < NTILE; ++j) {
                            if (row >= rows || ct * BN + j * 8 + 2 * tq >= n_cols) continue;
                            const float m0 = 1.f / (1.f + expf(-(acc[mt][j][2 * h] + bj[j])));
                            const float m1 = 1.f / (1.f + expf(-(acc[mt][j][2 * h + 1] + bj[j])));
                            const int64_t pos = rpos + cpos[j];
                            *reinterpret_cast<float2*>(mo + pos) = make_float2(m0, m1);
                            *reinterpret_cast<float2*>(go + pos) = make_float2(
                                m0 * sqrtf(x[j].x * x[j].x + x[j].y * x[j].y), m1 * sqrtf(x[j].z * x[j].z + x[j].w * x[j].w));
                        }
                    } else if (row < rows) {
#pragma unroll
                        for (int j = 0; j < NTILE; ++j)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int col = ct * BN + j * 8 + 2 * tq + e;
                                if (col >= n_cols) continue;
                                const int c = col / hop;
                                const int64_t pos = rpos + c * cstride + (col - c * hop);
                                const float m = 1.f / (1.f + expf(-(acc[mt][j][2 * h + e] + __ldg(bias + c))));
                                const float2 x = __ldg(xo + pos);
                                mo[pos] = m;
                                go[pos] = m * sqrtf(x.x * x.x + x.y * x.y);
                            }
                    }
                }
        }
    };

    // the ring: STAGES - 1 chunks in flight while one is computed
    int ict = 0, ic = 0;                 // the next chunk to issue
    auto issue_next = [&](int slot) {
        issue(ict, ic, slot);
        if (++ic == chunks) {
            ic = 0;
            ++ict;
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < total) issue_next(s);
        else cp_async_commit();
    }
    // column tiles, each summed over its chunks; the ring runs on across them, and the
    // epilogue stays out of the chunk loop (which keeps that loop small)
    for (int ct = 0, it = 0; ct < n_ct; ++ct) {
        const int nj = min(NTILE, (ldw - ct * BN) / 8);
        for (int c = 0; c < chunks; ++c, ++it) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();                 // chunk `it` landed for every thread; slot (it - 1) % STAGES is free
            if (it + STAGES - 1 < total) issue_next((it + STAGES - 1) % STAGES);
            else cp_async_commit();
            const int slot = it % STAGES;
#pragma unroll
            for (int kb = 0; kb < KB; ++kb) {
                const AT* A = As + (resident ? c : slot) * ASTAGE + kb * 8 * LDA + warp * 16 * MT;
                const float* B = Ws + slot * WSLOT + kb * GT * BN * 16;
                // A fragments: a0 (row g, step t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
                uint32_t ahi[MT][4], alo[MT][4];
                if constexpr (MODE == MODE_ENC1) {
                    int df[2], dk[2];
                    step(c * KC + kb * 8 + tq, df[0], dk[0]);
                    step(c * KC + kb * 8 + tq + 4, df[1], dk[1]);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int h = i & 1, k = tq + 4 * (i >> 1);
                            const int fi = ffr[mt][h] + df[i >> 1];
                            const bool ok = (unsigned)fi < (unsigned)fin && (unsigned)(fkr[mt][h] + dk[i >> 1]) < (unsigned)kin;
                            const float2 v = A[k * LDA + mt * 16 + gq + 8 * h];
                            const float2 ms = Wh[ok ? fi : 0];
                            const float x = (sqrtf(v.x * v.x + v.y * v.y) + ms.x) * ms.y;
                            split_tf32(ok ? x : 0.f, ahi[mt][i], alo[mt][i]);
                        }
                } else {
                    const AT* L = As + (resident ? c : slot) * ASTAGE + kb * (8 / LW) * LDL;
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            split_tf32(L[foff[i >> 1] + fpos[mt][i & 1]], ahi[mt][i], alo[mt][i]);
                }
                if (MODE == MODE_DEC2 && nj <= 2) mma_step<MT, 2, NJT>(acc, ahi, alo, B, gq, tq);   // dec2's T = 16
                else mma_step<MT, NJT, NJT>(acc, ahi, alo, B, gq, tq);   // columns past ldw are dropped
            }
        }
        epilogue(ct);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < NJT; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
    }
    cp_async_wait<0>();
}

// max_steps: the longest step table (R_pad) of the layer's plan rows; line: conv's line length, enc1's
// largest F
template <int MODE, int WARPS, int MT, int NTILE, int KC, int STAGES, int RES, int MINB, int GT = 1>
int launch(const void* in, const void* wt, const void* plan, const void* items, int32_t n_items, int32_t max_steps,
           int32_t line, const void* rtab, void* out, void* mags, const void* mix, void* stream) {
    using TL = Tile<MODE, WARPS, MT, NTILE, KC, STAGES, RES, MINB, GT>;
    auto kernel = cdae_layer_kernel<MODE, WARPS, MT, NTILE, KC, STAGES, RES, MINB, GT>;
    if (n_items > 0) {
        const int bytes = (int)TL::smem(max_steps, line);
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        kernel<<<(unsigned int)n_items, TL::NT, bytes, (cudaStream_t)stream>>>(
            (const float*)in, (const float*)wt, (const int64_t*)plan, (const int4*)items, (const int4*)rtab,
            (float*)out, (float*)mags, (const float2*)mix, max_steps, line);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Tiles (kernels/cdae_conv.py's ENC1_TILE, ENC1_TARGETS, CONV_TILE, DEC2_TILE,
// RC, DEC2_RESIDENT): enc1 128 rows x 56 columns of 2 targets in 8 warps, 8
// steps a chunk, a ring of 3 (its A tile holds complex pairs); enc2 and dec1
// 256 x 56 in 8 warps, 16 steps (4 lines) a chunk, a ring of 3; two blocks an
// SM. dec2 128 rows x 64 columns in 4 warps, 8 steps a chunk, a ring of 3, up
// to 13 chunks (R_pad <= 104: every fphi = 1 bucket) resident; three blocks
// an SM. (Measured against 4 warps of 64 rows, rings of 4 to 8, 16-step
// chunks and enc1 one target a block: tools/k4_variants.py.)
extern "C" int cdae_enc1(const void* x, const void* wt, const void* plan, const void* items, int32_t n_items,
                         int32_t max_steps, int32_t line, const void* rtab, void* h1, void* stream) {
    return launch<MODE_ENC1, 8, 1, 7, 8, 3, 0, 2, 2>(x, wt, plan, items, n_items, max_steps, line, rtab, h1, nullptr,
                                                  nullptr, stream);
}

extern "C" int cdae_enc2(const void* h1, const void* wt, const void* plan, const void* items, int32_t n_items,
                         int32_t max_steps, int32_t line, const void* rtab, void* h2, void* stream) {
    return launch<MODE_CONV, 8, 2, 7, 16, 3, 0, 2>(h1, wt, plan, items, n_items, max_steps, line, rtab, h2, nullptr,
                                                   nullptr, stream);
}

extern "C" int cdae_dec1(const void* h2, const void* wt, const void* plan, const void* items, int32_t n_items,
                         int32_t max_steps, int32_t line, const void* rtab, void* h3, void* stream) {
    return launch<MODE_CONV, 8, 2, 7, 16, 3, 0, 2>(h2, wt, plan, items, n_items, max_steps, line, rtab, h3, nullptr,
                                                   nullptr, stream);
}

extern "C" int cdae_dec2(const void* h3, const void* wt, const void* plan, const void* items, int32_t n_items,
                         int32_t max_steps, int32_t line, const void* rtab, void* masks, void* mags, const void* x,
                         void* stream) {
    return launch<MODE_DEC2, 4, 2, 8, 8, 3, 13, 3>(h3, wt, plan, items, n_items, max_steps, line, rtab, masks, mags,
                                                   x, stream);
}
