// K5: the LSTM recurrence of every bucket, target and direction, one layer
// per launch.
//
// Replaces the JAX package's xumx_slicq_tpu/models/lstm.py::_lstm_cell_scan
// (lstm.py:145-164), a lax.scan that XLA runs one step after another. For
// every sequence (bucket k, target t, direction d, batch row b) and step s:
//
//   gates = xp[s] + W_hh h;  i, f, o = sigmoid, g = tanh  (gate order i, f, g, o)
//   c = f c + i g;  h = o tanh(c)                          from h = c = 0
//
// xp already holds x W_ih^T + b_ih + b_hh. Direction 1 walks s downward and
// writes h at its own position s, as lax.scan(reverse=True) returns it.
// Layouts, packed per bucket at the offsets of a work item (floats):
//   xp   (4, dirs, frames, B, 4H)      read once
//   h    (4, frames, B, dirs * H)      written once, direction d in columns [dH, dH + H)
//   W^T  (4, dirs, H, 4H)              W_hh transposed, read once per block
//
// Bound: neither bytes nor operations but the serial chain. A sequence's
// steps depend on each other, so the layer costs its longest sequence
// (85,264 steps at bark-262 with the default chunk: H = 1 offline, H = 2
// realtime; the next are 67,744 steps at H = 2 and 4) times one step's
// time; the bytes (xp in, h out: 3.3 GB a layer at chunk batch 4) would
// take ~1 ms at 3.35 TB/s. On an H100 the previous design's step took 421
// cycles at H = 1 against a dependent chain of 168 (clock64 chains, a
// one-warp block): one warp dispatches in order, and its ~160 instructions a
// step (libm's tanhf five times with its range branches, 64-bit index
// multiplies for every load and store) did not hide behind the chain.
// Its wide buckets walked a block per sequence through W^T in L1 at 2.2 us
// (H = 43) and 4.1 us (H = 86) a step, which set the realtime layer.
// Design: one launch runs every sequence of every bucket at once, so the
// layer costs its longest chain and not the sum of the chains; the blocks
// are ordered longest chain first. Then the step is cut to its chain:
//   * Activations on the SFU: sigmoid(x) = 1 / (1 + 2^(-x log2 e)) and
//     tanh(x) = 2 sigmoid(2x) - 1, each one MUFU.EX2 and one MUFU.RCP
//     (~1e-7 absolute; tanh.approx's 2^-11 would be too coarse). W_hh and
//     the projections are taken in each row's scale (-log2 e, or -2 log2 e
//     for g), so a gate sum feeds ex2 directly, and the cell is carried as
//     zc = -2 log2(e) c, the argument of its tanh: the chain of a step is
//     gate FMA, EX2, FADD, RCP, FFMA, FFMA, EX2, FADD, RCP, FFMA, 106 cycles
//     at an H100's latencies (an FFMA 7, an FFMA and a MUFU 23).
//   * H <= 16: a group of GS lanes (the power of two >= H) walks a
//     sequence, lane j owning unit j: its four rows of W_hh in registers
//     and its cell; h crosses the group by shuffles. One lane owning all H
//     units (H <= 4) was built and timed slower: a warp's step then dispatches
//     10H MUFU operations, and the SFU's dispatch rate (~12 cycles a warp
//     instruction) set the step, not the chain. Projections run 16 steps (8
//     for GS >= 8) ahead in a register ring (16-byte loads of the row where H = GS)
//     and 32 further into L2; the walk has no branch a step (the loads are
//     clamped to the last step, not skipped): branches around the loads
//     and a test a step cost ~50 cycles a step at H = 1 (209 -> 159, timed
//     with clock64 inside the walk). Offsets are 32-bit products of the
//     step and a stride.
//   * H > 16 (the wide low buckets): a block per sequence, thread j owning
//     unit j (and j + 128, ... for H > 128: a loop over tiles of units),
//     all four of its gate rows, so the cell update needs no exchange: h is
//     double-buffered in shared memory, one barrier a step. W_hh is held in
//     shared memory (dynamic; 118 KB at H = 86) when it fits the card, read
//     16 bytes at a time without bank conflicts; above (H = 132, 263 at
//     linear-262) it streams from L2 every step: correct and slow (a
//     thread-block cluster holding it across SMs is the later design).
//   * The tensor cores do not help: the chains that set the time are a
//     4H x H by H product with H <= 4, and a wide step is 4H x H by H.
// In training the forward also writes the cell state c, packed like h
// (the `c` pointer; null when serving), a template parameter so that
// serving carries no trace of it.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

#define THREADS 128
#define ITEM_FIELDS 10        // H, frames, B, dirs, xp offset, h offset, W offset, first sequence, sequences,
                              // lanes per sequence (0: a block, W_hh in shared memory; -1: a block, W_hh from L2)

constexpr float LOG2E = 1.4426950408889634f;
constexpr float S_SIG = -LOG2E;            // an i, f or o row's scale: sigmoid(x) = 1 / (1 + 2^(S_SIG x))
constexpr float S_TANH = -2.f * LOG2E;     // a g row's and the cell's: tanh(x) = 2 / (1 + 2^(S_TANH x)) - 1

__device__ __forceinline__ float ex2_(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float rcp_(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 1 / (1 + 2^z): sigmoid(x) at z = S_SIG x, (1 + tanh(x)) / 2 at z = S_TANH x
__device__ __forceinline__ float logistic_(float z) { return rcp_(1.f + ex2_(z)); }

__device__ __forceinline__ float gate_scale(int gate) { return gate == 2 ? S_TANH : S_SIG; }

// One unit's step from its four gate sums z (each in its row's scale): i, f, o = logistic(z),
// r = logistic(z_g) so that g = 2r - 1; zc' = f zc + i S_TANH g; h = o tanh(c') = 2 o r' - o.
__device__ __forceinline__ float cell_(const float (&z)[4], float& zc) {
    const float i = logistic_(z[0]), f = logistic_(z[1]), r = logistic_(z[2]), o = logistic_(z[3]);
    zc = fmaf(i, fmaf(r, 2.f * S_TANH, -S_TANH), f * zc);
    return fmaf(o + o, logistic_(zc), -o);
}

constexpr int RING = 16;     // steps of projections a group walk holds in registers ahead of its chain
constexpr int AHEAD = 32;    // steps further ahead that it prefetches into L2

__device__ __forceinline__ void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// The gate sum of one row in its scale s, from its projection a and the K values hk of h against the
// row's K scaled weights w (zero past H): a s, then k ascending; for K >= 8 in two partial sums (even k
// onto a s, odd k onto zero) added last. K5b recomputes the forward's gates with these same sums.
template <int K>
__device__ __forceinline__ float row_sum(float a, float s, const float (&hk)[K], const float (&w)[K]) {
    float z = a * s;
    if constexpr (K >= 8) {
        float z1 = 0.f;
#pragma unroll
        for (int k = 0; k < K; k += 2) {
            z = fmaf(hk[k], w[k], z);
            z1 = fmaf(hk[k + 1], w[k + 1], z1);
        }
        return z + z1;
    } else {
#pragma unroll
        for (int k = 0; k < K; ++k) z = fmaf(hk[k], w[k], z);
        return z;
    }
}

// A group of GS lanes (the power of two >= H) walks sequence q = first + slot of a bucket: lane j owns unit
// j, its four rows of W_hh (scaled) and its cell. Lanes past H, or of a group past the last sequence,
// compute along (the shuffles need the whole warp) and neither load nor store. ROW (H == GS in {2, 4}):
// each lane reads the step's whole row of 4H projections in 16-byte loads and picks its unit's four.
template <int GS, bool CELL, bool ROW>
__device__ void group_sequence(const float* __restrict__ xp, const float* __restrict__ wT,
                               float* __restrict__ out, float* __restrict__ cout, int H, int frames, int B,
                               int dirs, int first, int n) {
    constexpr int P = GS >= 8 ? RING / 2 : RING;   // steps in the register ring ahead of the chain
                                                   // (fewer beside 4 x GS weights: no spills)
    const int j = threadIdx.x % GS;
    const int slot = threadIdx.x / GS;
    if ((int)(threadIdx.x & ~31u) / GS >= n) return;      // a warp with no sequence: leave its scheduler free
    const bool active = slot < n && j < H;
    const int q = first + (slot < n ? slot : 0);
    const int G = 4 * H;
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    // offsets from the walk's first row in 32 bits, a step times a stride (the wrapper checks the range)
    const int xrow = B * G, orow = B * dirs * H;                             // floats between two positions
    const int xstep = d ? -xrow : xrow, ostep = d ? -orow : orow;
    const int p0 = d ? frames - 1 : 0;                                        // the walk's first position
    const float* row = xp + ((int64_t)td * frames + p0) * xrow + (int64_t)b * G;
    float* o = out + ((int64_t)t * frames + p0) * orow + (int64_t)b * dirs * H + d * H + j;
    float* oc = CELL ? cout + (o - out) : nullptr;

    float W[4][GS];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k)
            W[gate][k] = (active && k < H)
                ? gate_scale(gate) * __ldg(wT + (int64_t)td * H * G + (int64_t)k * G + gate * H + j) : 0.f;

    // a step's four projections of unit j, from the row at p
    auto load = [&](const float* p, float (&r)[4]) {
        if (GS == 1) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(p));
            r[0] = f.x, r[1] = f.y, r[2] = f.z, r[3] = f.w;
        } else if (ROW && GS == 2) {
            const float4 a0 = __ldg(reinterpret_cast<const float4*>(p)), a1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
            r[0] = j ? a0.y : a0.x, r[1] = j ? a0.w : a0.z, r[2] = j ? a1.y : a1.x, r[3] = j ? a1.w : a1.z;
        } else if (ROW) {
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                const float4 a = __ldg(reinterpret_cast<const float4*>(p) + gate);
                r[gate] = j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
            }
        } else {
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) r[gate] = active ? __ldg(p + gate * H + j) : 0.f;
        }
    };
    float ring[P][4];
#pragma unroll
    for (int v = 0; v < P; ++v) {
        if (active && v < frames) load(row + v * xstep, ring[v]);
        else
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) ring[v][gate] = 0.f;
    }
    float h = 0.f, zc = 0.f;
    // step s from its projections r, which then take step s + P's (clamped to the last step: the loads and
    // the prefetch run unconditionally, so that a step has no branch to wait behind its MUFU operations)
    auto step = [&](float (&r)[4], int s) {
        float hk[GS];
#pragma unroll
        for (int k = 0; k < GS; ++k) hk[k] = GS == 1 ? h : (k < H ? __shfl_sync(0xffffffffu, h, k, GS) : 0.f);
        float z[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) z[gate] = row_sum<GS>(r[gate], gate_scale(gate), hk, W[gate]);
        load(row + min(s + P, frames - 1) * xstep, r);
        prefetch_l2(row + min(s + P + AHEAD, frames - 1) * xstep);
        h = cell_(z, zc);
        if (active) {
            o[s * ostep] = h;
            if (CELL) oc[s * ostep] = zc * (1.f / S_TANH);
        }
    };
    int s0 = 0;
    for (; s0 + P <= frames; s0 += P)                     // whole rounds of the ring: no test a step
#pragma unroll
        for (int v = 0; v < P; ++v) step(ring[v], s0 + v);
#pragma unroll
    for (int v = 0; v < P; ++v)                            // the rest
        if (s0 + v < frames) step(ring[v], s0 + v);
}

// Dynamic shared memory of the block path: h double-buffered (2 Hp floats, Hp = H rounded up to 4,
// zero-padded), the cells of units past the first tile (Hp), then with W_hh held, W_hh (H units of
// unit_stride(Hp) floats: rows gate Hp + k of unit j at j unit_stride + gate Hp + k, zero past H).
// A unit's stride of 4 Hp + 4 floats is an odd number of 16-byte words: a quarter warp's 16-byte reads
// of 8 units fall on 8 different bank groups.
__host__ __device__ constexpr int padded_h(int H) { return (H + 3) & ~3; }
__host__ __device__ constexpr int unit_stride(int Hp) { return 4 * Hp + 4; }

// A block walks sequence q of a bucket with hidden size H > 16: thread tid owns units tid, tid +
// THREADS, ...: all four gate rows and the cell of each. Per step and unit the four row sums run over
// h in 16-byte pieces, k ascending from zero, the projection added and the sum taken into the row's scale
// (one multiply, so that K5b repeats the sums with W_hh as it is stored); then the cell. One barrier a
// step: the next step reads the other h buffer.
template <bool CELL, bool W_SMEM>
__device__ void block_sequence(const float* __restrict__ xp, const float* __restrict__ wT,
                               float* __restrict__ out, float* __restrict__ cout, int H, int frames, int B,
                               int dirs, int q, float* smem) {
    constexpr int P = 4;                             // steps of tile 0's projections in registers ahead
    const int Hp = padded_h(H), WS = unit_stride(Hp), G = 4 * H;
    float* hb = smem;                                // [2][Hp]
    float* zcs = smem + 2 * Hp;                      // [Hp]: cells of units >= THREADS
    float* ws = smem + 3 * Hp;                       // [H][WS] when W_SMEM
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const int64_t xrow = (int64_t)B * G, orow = (int64_t)B * dirs * H;
    const int64_t xstep = d ? -xrow : xrow, ostep = d ? -orow : orow;
    const int p0 = d ? frames - 1 : 0;
    const float* x = xp + ((int64_t)td * frames + p0) * xrow + (int64_t)b * G;
    float* o = out + ((int64_t)t * frames + p0) * orow + (int64_t)b * dirs * H + d * H;
    float* oc = CELL ? cout + (o - out) : nullptr;
    const float* w = wT + (int64_t)td * H * G;
    const int tid = threadIdx.x;

    for (int e = tid; e < 3 * Hp; e += THREADS) smem[e] = 0.f;
    if (W_SMEM) {
        for (int e = tid; e < H * G; e += THREADS) {                 // coalesced: W^T row k, column gate H + j
            const int k = e / G, col = e % G, gate = col / H, jj = col % H;
            ws[jj * WS + gate * Hp + k] = __ldg(w + e);
        }
        for (int e = tid; e < H * 4 * (Hp - H); e += THREADS) {     // the padding past H
            const int jj = e / (4 * (Hp - H)), r = e % (4 * (Hp - H));
            ws[jj * WS + (r / (Hp - H)) * Hp + H + r % (Hp - H)] = 0.f;
        }
    }
    float ring[P][4];
#pragma unroll
    for (int v = 0; v < P; ++v)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
            ring[v][gate] = (tid < H && v < frames) ? __ldg(x + v * xstep + gate * H + tid) : 0.f;
    const float* xn = x + P * xstep;
    float zc0 = 0.f;
    __syncthreads();

    // unit j's step: its four row sums against h (hcur) and projections a, its cell zc; returns h
    auto unit = [&](int j, const float* hcur, const float (&a)[4], float& zc) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float4* h4 = reinterpret_cast<const float4*>(hcur);
        const float* wj = ws + j * WS;
#pragma unroll 4
        for (int k4 = 0; k4 < Hp / 4; ++k4) {
            const float4 hv = h4[k4];
            float4 wv[4];
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                if (W_SMEM) {
                    wv[gate] = reinterpret_cast<const float4*>(wj + gate * Hp)[k4];
                } else {
                    const float* wk = w + (int64_t)(4 * k4) * G + gate * H + j;
                    wv[gate].x = __ldg(wk);
                    wv[gate].y = 4 * k4 + 1 < H ? __ldg(wk + G) : 0.f;
                    wv[gate].z = 4 * k4 + 2 < H ? __ldg(wk + 2 * G) : 0.f;
                    wv[gate].w = 4 * k4 + 3 < H ? __ldg(wk + 3 * G) : 0.f;
                }
            }
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                acc[gate] = fmaf(hv.x, wv[gate].x, acc[gate]);
                acc[gate] = fmaf(hv.y, wv[gate].y, acc[gate]);
                acc[gate] = fmaf(hv.z, wv[gate].z, acc[gate]);
                acc[gate] = fmaf(hv.w, wv[gate].w, acc[gate]);
            }
        }
        float z[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) z[gate] = (a[gate] + acc[gate]) * gate_scale(gate);
        return cell_(z, zc);
    };

    for (int s0 = 0; s0 < frames; s0 += P) {
#pragma unroll
        for (int v = 0; v < P; ++v) {
            const int s = s0 + v;
            if (s >= frames) break;                        // uniform across the block
            const float* hcur = hb + (s & 1) * Hp;
            float* hnext = hb + ((s + 1) & 1) * Hp;
            if (tid < H) {
                const float a[4] = {ring[v][0], ring[v][1], ring[v][2], ring[v][3]};
                if (s + P < frames)
#pragma unroll
                    for (int gate = 0; gate < 4; ++gate) ring[v][gate] = __ldg(xn + gate * H + tid);
                const float hv = unit(tid, hcur, a, zc0);
                hnext[tid] = hv;
                o[tid] = hv;
                if (CELL) oc[tid] = zc0 * (1.f / S_TANH);
            }
            for (int j = tid + THREADS; j < H; j += THREADS) {     // units past the first tile: no ring
                const float* xs = xn - P * xstep;
                const float a[4] = {__ldg(xs + j), __ldg(xs + H + j), __ldg(xs + 2 * H + j), __ldg(xs + 3 * H + j)};
                float zc = zcs[j];
                const float hv = unit(j, hcur, a, zc);
                zcs[j] = zc;
                hnext[j] = hv;
                o[j] = hv;
                if (CELL) oc[j] = zc * (1.f / S_TANH);
            }
            xn += xstep;
            o += ostep;
            if (CELL) oc += ostep;
            __syncthreads();                               // h of step s is in; step s - 1's buffer is free
        }
    }
}

template <bool CELL>
__global__ void __launch_bounds__(THREADS)
lstm_recurrence_kernel(const float* __restrict__ xp, const float* __restrict__ wT, float* __restrict__ out,
                       float* __restrict__ cout, const int64_t* __restrict__ items) {
    extern __shared__ float4 smem4[];
    const int64_t* it = items + (int64_t)blockIdx.x * ITEM_FIELDS;
    const int H = (int)it[0], frames = (int)it[1], B = (int)it[2], dirs = (int)it[3];
    const float* x = xp + it[4];
    float* o = out + it[5];
    float* oc = CELL ? cout + it[5] : nullptr;
    const float* w = wT + it[6];
    const int first = (int)it[7], n = (int)it[8], lanes = (int)it[9];
    if (lanes == 0) return block_sequence<CELL, true>(x, w, o, oc, H, frames, B, dirs, first, (float*)smem4);
    if (lanes < 0) return block_sequence<CELL, false>(x, w, o, oc, H, frames, B, dirs, first, (float*)smem4);
    switch (lanes) {                       // the work table's lanes: the power of two >= H
        case 1: group_sequence<1, CELL, false>(x, w, o, oc, H, frames, B, dirs, first, n); break;
        case 2: group_sequence<2, CELL, true>(x, w, o, oc, H, frames, B, dirs, first, n); break;
        case 4:
            if (H == 4) group_sequence<4, CELL, true>(x, w, o, oc, H, frames, B, dirs, first, n);
            else group_sequence<4, CELL, false>(x, w, o, oc, H, frames, B, dirs, first, n);
            break;
        case 8: group_sequence<8, CELL, false>(x, w, o, oc, H, frames, B, dirs, first, n); break;
        default: group_sequence<16, CELL, false>(x, w, o, oc, H, frames, B, dirs, first, n); break;
    }
}

// ---------------------------------------------------------------------------
// K5b: the backward through time of one layer, every sequence at once.
//
// Replaces XLA's autodiff of the same lax.scan in the JAX package's train
// step (xumx_slicq_tpu/training.py:273-274 through models/lstm.py:145-164).
// Each sequence walks the reverse of its forward walk; per step, from
// dh_rec = dc_rec = 0:
//
//   gates recomputed from xp[s] + W_hh h_prev (h_prev, c_prev: the forward's
//   h and c one step earlier in its walk, zero at its first step)
//   dh = dh_out[s] + dh_rec;  tc = tanh(c_s);  dc = dc_rec + dh o (1 - tc^2)
//   d(xp)[s] = (dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), dh tc o(1-o))
//   dh_rec = W_hh^T d(xp)[s];  dc_rec = dc f
//
// Layouts as the forward's; c and dh packed like h, d(xp) like xp. After
// its walk each sequence also sums d(W_hh^T) = sum over steps of h_prev (x)
// d(xp) for itself, into its row b of a (B, W size) buffer of partials that
// the wrapper sums over b in a fixed order (no atomics: two runs give
// bit-equal gradients). Its weights are dead by then, so the sums add no
// registers to the walk.
// Bound: the serial chain again, now the W_hh^T matvec, dh_rec_j =
// sum_r W[r][j] d(xp)[r] over all 4H gate rows, then the cell's few
// products. The gate recompute reads only saved values, so it is off the
// chain. Bytes: xp, h, c and dh read, d(xp) and the partials written; the
// pass for d(W_hh) reads d(xp) and h again, from L2 mostly.
// The gates are recomputed with the forward's activations (ex2 and rcp)
// and its order of sums (row_sum for H <= 16, k ascending then the
// scale for the wide buckets), so they are the forward's bit for bit;
// tanh(c) is taken from the saved c.
// Design: the forward's split, with its own work table (a group of GS
// lanes per sequence, GS the power of two >= H, for H <= 16).
//   * H <= 16: lane j owns unit j: its four rows of W_hh (scaled, for the
//     recompute) and its column of W_hh (the 4H-long row j of the packed
//     W^T, for dh_rec), both in registers; h_prev and each lane's four gate
//     gradients broadcast by shuffles. Loads run one step ahead in
//     registers and further ahead into L2. d(W_hh): lane j sums its four
//     rows against h_prev, broadcast by shuffles, 4 x GS sums in registers.
//   * H > 16: a block per sequence: gate rows recomputed up to ROWS a
//     thread in one pass over h_prev (tiles of rows for any 4H), the cells
//     in threads j, j + THREADS, ... < H, the gradients of the 4H rows in
//     shared memory (dynamic, 10H floats), and dh_rec with each warp taking
//     units in turn, its lanes splitting the 4H rows of W^T row j
//     (coalesced) and reducing by shuffles. Two barriers a step. d(W_hh):
//     after a barrier, thread r sums its gate rows against KC columns of
//     h_prev at a time.

template <int GS>
__device__ void group_sequence_backward(const float* __restrict__ xp, const float* __restrict__ wT,
                                        const float* __restrict__ hseq, const float* __restrict__ cseq,
                                        const float* __restrict__ dhseq, float* __restrict__ dxp,
                                        float* __restrict__ dw, int64_t wsize, int H, int64_t frames, int B,
                                        int dirs, int first, int n) {
    const int j = threadIdx.x % GS;
    const int slot = threadIdx.x / GS;
    if ((int)(threadIdx.x & ~31u) / GS >= n) return;
    const bool active = slot < n && j < H;
    const int q = first + (slot < n ? slot : 0);
    const int G = 4 * H;
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const int64_t xoff = (int64_t)td * frames * B * G + (int64_t)b * G + j;
    const float* x = xp + xoff;
    float* dx = dxp + xoff;
    const int64_t xstride = (int64_t)B * G;
    const int64_t hoff = (int64_t)t * frames * B * dirs * H + (int64_t)b * dirs * H + d * H + j;
    const float* hp_ = hseq + hoff;
    const float* cp_ = cseq + hoff;
    const float* dh_ = dhseq + hoff;
    const int64_t hstride = (int64_t)B * dirs * H;
    const float* w = wT + (int64_t)td * H * G;

    float W[4][GS], WT[4][GS];           // row gate*H + j of W_hh, scaled; column j of W_hh (row j of W^T)
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            W[gate][k] = (active && k < H) ? gate_scale(gate) * __ldg(w + (int64_t)k * G + gate * H + j) : 0.f;
            WT[gate][k] = (active && k < H) ? __ldg(w + (int64_t)j * G + gate * H + k) : 0.f;
        }

    // walk step u sits at position pos(u); the backward takes u from frames - 1 down
    auto pos = [&](int64_t u) { return d ? frames - 1 - u : u; };
    int64_t u = frames - 1;
    float a[4], dho = 0.f, cc = 0.f, cp = 0.f, hp = 0.f;
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) a[gate] = active ? __ldg(x + pos(u) * xstride + gate * H) : 0.f;
    if (active) {
        dho = __ldg(dh_ + pos(u) * hstride);
        cc = __ldg(cp_ + pos(u) * hstride);
        if (u > 0) {
            cp = __ldg(cp_ + pos(u - 1) * hstride);
            hp = __ldg(hp_ + pos(u - 1) * hstride);
        }
    }
    float dh_rec = 0.f, dc_rec = 0.f;
    for (; u >= 0; --u) {
        // step u - 1's inputs, loaded while step u computes
        float na[4] = {0.f, 0.f, 0.f, 0.f}, ndh = 0.f, nc = 0.f, nh = 0.f;
        if (active && u >= 1) {
            const int64_t p1 = pos(u - 1);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) na[gate] = __ldg(x + p1 * xstride + gate * H);
            ndh = __ldg(dh_ + p1 * hstride);
            if (u >= 2) {
                nc = __ldg(cp_ + pos(u - 2) * hstride);
                nh = __ldg(hp_ + pos(u - 2) * hstride);
            }
            if (u - 1 - AHEAD >= 0) {
                const int64_t pf = pos(u - 1 - AHEAD);
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) prefetch_l2(x + pf * xstride + gate * H);
                prefetch_l2(dh_ + pf * hstride);
                prefetch_l2(cp_ + pf * hstride);
                prefetch_l2(hp_ + pf * hstride);
            }
        }
        // the forward's gates, recomputed with its activations and row_sum's sums (each h_k shuffled once
        // for the four rows: no array of h held)
        float z[4], z1[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) z[gate] = a[gate] * gate_scale(gate), z1[gate] = 0.f;
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            const float hk = GS == 1 ? hp : __shfl_sync(0xffffffffu, hp, k, GS);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                if (GS >= 8 && (k & 1)) z1[gate] = fmaf(hk, W[gate][k], z1[gate]);
                else z[gate] = fmaf(hk, W[gate][k], z[gate]);
            }
        }
        if (GS >= 8)
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) z[gate] += z1[gate];
        const float ig = logistic_(z[0]), fg = logistic_(z[1]), og = logistic_(z[3]);
        const float gg = fmaf(logistic_(z[2]), 2.f, -1.f);
        const float tc = fmaf(logistic_(cc * S_TANH), 2.f, -1.f);
        const float dh = dho + dh_rec;
        const float dc = dc_rec + dh * og * (1.f - tc * tc);
        float dg[4];
        dg[0] = dc * gg * ig * (1.f - ig);
        dg[1] = dc * cp * fg * (1.f - fg);
        dg[2] = dc * ig * (1.f - gg * gg);
        dg[3] = dh * tc * og * (1.f - og);
        if (active) {
            const int64_t p = pos(u);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) dx[p * xstride + gate * H] = dg[gate];
        }
        // dh_rec_j = sum over the group's lanes k and gates of W[gate H + k][j] dg_gate(k)
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < GS; ++k)
#pragma unroll
            for (int gate = 0; gate < 4; ++gate)
                s = fmaf(WT[gate][k], GS == 1 ? dg[gate] : __shfl_sync(0xffffffffu, dg[gate], k, GS), s);
        dh_rec = s;
        dc_rec = dc * fg;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) a[gate] = na[gate];
        dho = ndh;
        cc = cp;
        cp = nc;
        hp = nh;
    }
    // d(W_hh^T)[k][gate H + j] of this sequence: sum over walk steps u >= 1 of d(xp)[u] h_k[u - 1],
    // d(xp) as this lane wrote it above (plain loads: written in this kernel)
    float acc[4][GS];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k) acc[gate][k] = 0.f;
    for (int64_t v = 1; v < frames; ++v) {
        const int64_t p = pos(v);
        float dg[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) dg[gate] = active ? dx[p * xstride + gate * H] : 0.f;
        const float hv = active ? __ldg(hp_ + pos(v - 1) * hstride) : 0.f;
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            const float hk = GS == 1 ? hv : __shfl_sync(0xffffffffu, hv, k, GS);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) acc[gate][k] = fmaf(dg[gate], hk, acc[gate][k]);
        }
    }
    if (active) {
        float* o = dw + (int64_t)b * wsize + (int64_t)td * H * G + j;
#pragma unroll
        for (int k = 0; k < GS; ++k)
            if (k < H)
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) o[(int64_t)k * G + gate * H] = acc[gate][k];
    }
}

__device__ void block_sequence_backward(const float* __restrict__ xp, const float* __restrict__ wT,
                                        const float* __restrict__ hseq, const float* __restrict__ cseq,
                                        const float* __restrict__ dhseq, float* __restrict__ dxp,
                                        float* __restrict__ dw, int64_t wsize, int H, int64_t frames, int B,
                                        int dirs, int q, float* smem) {
    constexpr int ROWS = 4;                                // gate rows a thread takes in one pass
    constexpr int KC = 8;                                  // columns of d(W_hh^T) summed at once
    const int G = 4 * H;
    float* gates = smem;                                   // [G]
    float* dgs = smem + G;                                 // [G]
    float* dhr = smem + 2 * G;                             // [H]: dh_rec
    float* dcr = dhr + H;                                  // [H]: dc_rec
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const int64_t xoff = (int64_t)td * frames * B * G + (int64_t)b * G;
    const float* x = xp + xoff;
    float* dx = dxp + xoff;
    const int64_t xstride = (int64_t)B * G;
    const int64_t hoff = (int64_t)t * frames * B * dirs * H + (int64_t)b * dirs * H + d * H;
    const float* hs = hseq + hoff;
    const float* cs = cseq + hoff;
    const float* dhs = dhseq + hoff;
    const int64_t hstride = (int64_t)B * dirs * H;
    const float* w = wT + (int64_t)td * H * G;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int j = tid; j < H; j += THREADS) dhr[j] = dcr[j] = 0.f;
    for (int64_t u = frames - 1; u >= 0; --u) {
        const int64_t p = d ? frames - 1 - u : u;
        const int64_t pp = d ? p + 1 : p - 1;                  // step u - 1 of the forward walk
        // the forward's gate sums (block_sequence): k ascending from zero, the projection added, then the
        // row's scale; h_prev = 0 at the walk's first step. All of a thread's rows in one pass over h.
        for (int r0 = 0; r0 < G; r0 += ROWS * THREADS) {
            float acc[ROWS];
#pragma unroll
            for (int k = 0; k < ROWS; ++k) acc[k] = 0.f;
            if (u > 0) {
#pragma unroll 2
                for (int j = 0; j < H; ++j) {
                    const float hj = __ldg(hs + pp * hstride + j);
                    const float* wj = w + (int64_t)j * G + r0 + tid;
#pragma unroll
                    for (int k = 0; k < ROWS; ++k)
                        if (r0 + tid + k * THREADS < G) acc[k] = fmaf(hj, __ldg(wj + k * THREADS), acc[k]);
                }
            }
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
                const int r = r0 + tid + k * THREADS;
                if (r < G) {
                    const int gate = r / H;
                    const float z = (__ldg(x + p * xstride + r) + acc[k]) * gate_scale(gate);
                    gates[r] = gate == 2 ? fmaf(logistic_(z), 2.f, -1.f) : logistic_(z);
                }
            }
        }
        __syncthreads();                                   // the gates of step u are in; dh_rec of step u + 1 too
        for (int j = tid; j < H; j += THREADS) {
            const float ig = gates[j], fg = gates[H + j], gg = gates[2 * H + j], og = gates[3 * H + j];
            const float tc = fmaf(logistic_(__ldg(cs + p * hstride + j) * S_TANH), 2.f, -1.f);
            const float cp = u > 0 ? __ldg(cs + pp * hstride + j) : 0.f;
            const float dh = __ldg(dhs + p * hstride + j) + dhr[j];
            const float dc = dcr[j] + dh * og * (1.f - tc * tc);
            const float dg[4] = {dc * gg * ig * (1.f - ig), dc * cp * fg * (1.f - fg), dc * ig * (1.f - gg * gg),
                                 dh * tc * og * (1.f - og)};
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                dgs[gate * H + j] = dg[gate];
                dx[p * xstride + gate * H + j] = dg[gate];
            }
            dcr[j] = dc * fg;
        }
        __syncthreads();                                   // every gate gradient of step u is in
        for (int j = warp; j < H; j += THREADS / 32) {
            float s = 0.f;
            for (int r = lane; r < G; r += 32) s = fmaf(__ldg(w + (int64_t)j * G + r), dgs[r], s);
#pragma unroll
            for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (lane == 0) dhr[j] = s;
        }
        // no barrier here: dhr is read, and dgs written, only after the next step's first barrier
    }
    __syncthreads();                                       // every d(xp) of the sequence is in
    // d(W_hh^T)[k][r] of this sequence: sum over walk steps u >= 1 of d(xp)[u][r] h_k[u - 1]
    float* o = dw + (int64_t)b * wsize + (int64_t)td * H * G;
    for (int r0 = 0; r0 < G; r0 += ROWS * THREADS)
        for (int k0 = 0; k0 < H; k0 += KC) {
            float acc[ROWS][KC];
#pragma unroll
            for (int k = 0; k < ROWS; ++k)
#pragma unroll
                for (int c = 0; c < KC; ++c) acc[k][c] = 0.f;
            for (int64_t v = 1; v < frames; ++v) {
                const int64_t p = d ? frames - 1 - v : v;
                const int64_t pp = d ? p + 1 : p - 1;
                float hk[KC];
#pragma unroll
                for (int c = 0; c < KC; ++c) hk[c] = k0 + c < H ? __ldg(hs + pp * hstride + k0 + c) : 0.f;
#pragma unroll
                for (int k = 0; k < ROWS; ++k) {
                    const int r = r0 + tid + k * THREADS;
                    if (r < G) {
                        const float g = dx[p * xstride + r];
#pragma unroll
                        for (int c = 0; c < KC; ++c) acc[k][c] = fmaf(g, hk[c], acc[k][c]);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
                const int r = r0 + tid + k * THREADS;
                if (r < G)
#pragma unroll
                    for (int c = 0; c < KC; ++c)
                        if (k0 + c < H) o[(int64_t)(k0 + c) * G + r] = acc[k][c];
            }
        }
}

__global__ void __launch_bounds__(THREADS)
lstm_recurrence_backward_kernel(const float* __restrict__ xp, const float* __restrict__ wT,
                                const float* __restrict__ h, const float* __restrict__ c,
                                const float* __restrict__ dh, float* __restrict__ dxp, float* __restrict__ dw,
                                int64_t wsize, const int64_t* __restrict__ items) {
    extern __shared__ float4 smem4[];
    const int64_t* it = items + (int64_t)blockIdx.x * ITEM_FIELDS;
    const int H = (int)it[0], B = (int)it[2], dirs = (int)it[3];
    const int64_t frames = it[1];
    const float* x = xp + it[4];
    float* dx = dxp + it[4];
    const float* hh = h + it[5];
    const float* cc = c + it[5];
    const float* dd = dh + it[5];
    const float* w = wT + it[6];
    float* g = dw + it[6];
    const int first = (int)it[7], n = (int)it[8], lanes = (int)it[9];
    switch (lanes) {
        case 1: group_sequence_backward<1>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n); break;
        case 2: group_sequence_backward<2>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n); break;
        case 4: group_sequence_backward<4>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n); break;
        case 8: group_sequence_backward<8>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n); break;
        case 16: group_sequence_backward<16>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n); break;
        default:
            block_sequence_backward(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first,
                                    reinterpret_cast<float*>(smem4));
    }
}

// The dynamic shared memory a block may opt in to on the current device (bytes).
extern "C" int lstm_recurrence_smem_limit() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
    return bytes;
}

static cudaError_t allow_smem(const void* kernel, int64_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// K5 over a work table of n_items rows with smem bytes of dynamic shared memory a block. c: null when
// serving; in training the forward writes the cell state there, packed like out.
extern "C" int lstm_recurrence(const void* xp, const void* wT, void* out, void* c, const void* items,
                               int64_t n_items, int64_t smem, void* stream) {
    if (n_items <= 0) return 0;
    void (*kernel)(const float*, const float*, float*, float*, const int64_t*) =
        c ? lstm_recurrence_kernel<true> : lstm_recurrence_kernel<false>;
    cudaError_t e = allow_smem((const void*)kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned int)n_items, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)wT, (float*)out, (float*)c, (const int64_t*)items);
    return (int)cudaGetLastError();
}

// K5b over its work table: d(xp) from the forward's xp, W^T, h, c and the cotangent dh, and each
// sequence's d(W_hh^T) in row b of dw, (B, wsize) floats.
extern "C" int lstm_recurrence_backward(const void* xp, const void* wT, const void* h, const void* c,
                                        const void* dh, void* dxp, void* dw, int64_t wsize, const void* items,
                                        int64_t n_items, int64_t smem, void* stream) {
    if (n_items <= 0) return 0;
    cudaError_t e = allow_smem((const void*)lstm_recurrence_backward_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    lstm_recurrence_backward_kernel<<<(unsigned int)n_items, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)wT, (const float*)h, (const float*)c, (const float*)dh, (float*)dxp,
        (float*)dw, wsize, (const int64_t*)items);
    return (int)cudaGetLastError();
}
