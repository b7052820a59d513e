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

// A step's four projections of unit j from the row at p (4H floats, gate-major). ROW (H == GS in {2, 4}):
// the lane reads the whole row in 16-byte loads and picks its unit's four; GS == 1 reads its one float4.
// Otherwise four loads, zeros where the lane is not active.
template <int GS, bool ROW>
__device__ __forceinline__ void load_projections(const float* p, int j, int H, bool active, float (&r)[4]) {
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

    auto load = [&](const float* p, float (&r)[4]) { load_projections<GS, ROW>(p, j, H, active, r); };
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

// Unit j's four gate row sums against h (Hp floats in shared memory, zero past H), k ascending from zero in
// 16-byte pieces: W_hh from shared memory (rows of unit j at wj, unit_stride layout) or from W^T in L2.
// K5b recomputes K5's gates with this same function.
template <bool W_SMEM>
__device__ __forceinline__ void block_row_sums(const float* wj, const float* w, int j, int H, int Hp,
                                               const float* hcur, float (&acc)[4]) {
    const int G = 4 * H;
    const float4* h4 = reinterpret_cast<const float4*>(hcur);
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) acc[gate] = 0.f;
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
}

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
        float acc[4];
        block_row_sums<W_SMEM>(ws + j * WS, w, j, H, Hp, hcur, acc);
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
// and d(W_hh^T) = sum over steps of h_prev (x) d(xp). Layouts as the
// forward's; c and dh packed like h, d(xp) like xp. Each sequence sums its
// own d(W_hh^T) into its row b of a (B, W size) buffer of partials that the
// wrapper sums over b in a fixed order (no atomics: two runs give bit-equal
// gradients).
// The gates are recomputed with the forward's activations (ex2 and rcp) and
// its sums (row_sum for H <= 16, block_row_sums for the wide buckets), so
// they are the forward's bit for bit; tanh(c) is taken from the saved c.
// Bound: bytes (xp, h, c, dh read, d(xp) written: 2.19 GB a layer at batch
// 32 of 2 s, 0.65 ms); a step's dependent chain (dh, dc, the gate
// gradients, dh_rec) is 30 cycles at H = 1 (clock64 on an H100), far under
// a step's issue and the layer's blocks' occupancy of the SMs, which set it:
// this design takes 1.56 / 2.81 ms a layer offline / realtime there, the
// realtime one held to one block an SM by W_hh of its H = 86 bucket.
// The previous design took 5.06 / 6.02 ms: its group walk loaded one step ahead, so a step
// waited on device memory (~370 ns a step at H = 1), then took a second
// walk over every frame for d(W_hh) (~150 ns a step, no lookahead); its
// wide blocks read W^T from L2 twice a step behind two barriers (H = 43:
// 8.3 us a step, H = 86: 14.8 us); and the kernel held 255 registers with
// spills, two blocks an SM, so its 616-648 blocks ran in ~2.5 waves.
// Design:
//   * H <= 16: a group of GS lanes per sequence as in K5, lane j owning
//     unit j with its four rows of W_hh scaled as K5 scales them. A P-step
//     register ring holds each step's projections, dh, c_prev and h_prev;
//     loads are clamped to the walk's last step, never skipped, and an L2
//     prefetch runs further ahead; offsets are 32-bit. dh_rec needs
//     column j of W_hh, which lies in the other lanes' rows: lane m forms
//     its contributions to every unit k from its own rows (4 GS FMAs with
//     the gate gradients divided by the rows' scales) and the group sums
//     them with a reduce-scatter of GS - 1 shuffles, in place of 4 GS
//     shuffles and a held transposed copy. d(W_hh) is summed inside the
//     walk from the h_prev the recompute has shuffled already (4 GS
//     registers), but for GS = 16 in the build held to 168 registers,
//     which sums it in a second ring walk. Each step forms the next
//     step's gates and factors (ten MUFU operations) beside its own
//     dependent chain, so that their latencies overlap.
//   * H > 16: a block per sequence, thread j owning unit j (and j + 128,
//     ... for H > 128), all four of its gates, so the cell's backward needs
//     no exchange. W_hh is held in shared memory in K5's layout where it
//     fits (127 KB at H = 86); the recompute reads unit j's rows 16 bytes
//     at a time, dh_rec its column (conflict-free: consecutive units,
//     consecutive words). h_prev is staged a step ahead and the gate
//     gradients exchanged through double buffers: one barrier a step.
//     Without room (H = 132, 263 at linear-262) W^T is read from L2, dh_rec
//     a warp per unit across the row (coalesced). d(W_hh) follows the walk
//     as a pass over the sequence's d(xp), with h_prev staged in the shared
//     memory W_hh leaves (from L2 without it).
//   * Launch bounds by table: where three blocks' shared memory fits an SM,
//     a build held to 168 registers (three blocks an SM); else, W_hh held
//     for a wide bucket leaving one block an SM, the build with 255.
// K5B_NO_DW_PASS (defined only by the timing builds of chip_smoke.py and tools/k5_ab.py) leaves the
// separate d(W_hh) passes out.

constexpr float INV_S_SIG = 1.f / S_SIG, INV_S_TANH = 1.f / S_TANH;

// What one unit's backward step needs beside the carried dh_rec and dc_rec, from its recomputed gate sums z
// (in the rows' scales) and its cells c and c_prev: dg = (dc g[0], dc g[1], dc g[2], dh g[3]) with
// dc = dc_rec + dh kd, then dc_rec = dc f. None of it waits on the previous step.
struct CellFactors {
    float g[4], kd, f;
};

__device__ __forceinline__ CellFactors cell_factors_(const float (&z)[4], float c, float cp) {
    const float ig = logistic_(z[0]), fg = logistic_(z[1]), og = logistic_(z[3]);
    const float gg = fmaf(logistic_(z[2]), 2.f, -1.f);
    const float tc = fmaf(logistic_(c * S_TANH), 2.f, -1.f);
    CellFactors a;
    a.g[0] = gg * ig * (1.f - ig);
    a.g[1] = cp * fg * (1.f - fg);
    a.g[2] = ig * (1.f - gg * gg);
    a.g[3] = tc * og * (1.f - og);
    a.kd = og * (1.f - tc * tc);
    a.f = fg;
    return a;
}

// The step's part on the dependent chain: dh = dh_out + dh_rec in, the gate gradients dg out, dc_rec carried.
__device__ __forceinline__ void cell_chain_(const CellFactors& a, float dh, float& dc_rec, float (&dg)[4]) {
    const float dc = fmaf(dh, a.kd, dc_rec);
    dg[0] = dc * a.g[0];
    dg[1] = dc * a.g[1];
    dg[2] = dc * a.g[2];
    dg[3] = dh * a.g[3];
    dc_rec = dc * a.f;
}

// Lane m's contributions to dh_rec of the group's units k: sum over gates of W_hh[gate H + m][k] dg_gate,
// from the lane's scaled rows W (W[gate][k] = s_gate W_hh[gate H + m][k]).
template <int GS>
__device__ __forceinline__ void rec_contributions(const float (&W)[4][GS], const float (&dg)[4], float (&cv)[GS]) {
    const float e0 = dg[0] * INV_S_SIG, e1 = dg[1] * INV_S_SIG, e2 = dg[2] * INV_S_TANH, e3 = dg[3] * INV_S_SIG;
#pragma unroll
    for (int k = 0; k < GS; ++k) cv[k] = fmaf(W[0][k], e0, W[1][k] * e1) + fmaf(W[2][k], e2, W[3][k] * e3);
}

// The group's sum of cv over its lanes, element j to lane j: recursive halving, GS - 1 shuffles a lane.
template <int GS>
__device__ __forceinline__ float reduce_scatter(float (&cv)[GS], int j) {
#pragma unroll
    for (int o = GS / 2; o >= 1; o /= 2) {
        const bool up = j & o;
#pragma unroll
        for (int i = 0; i < o; ++i) {
            const float send = up ? cv[i] : cv[i + o];
            cv[i] = (up ? cv[i + o] : cv[i]) + __shfl_xor_sync(0xffffffffu, send, o);
        }
    }
    return cv[0];
}

template <int GS>
__host__ __device__ constexpr int backward_ring() { return GS >= 8 ? 4 : 8; }   // steps a group walk holds ahead

// A group of GS lanes walks sequence q = first + slot backward (lanes as in group_sequence). Walk index i
// counts the backward's steps: forward step u = frames - 1 - i, at position p0 + u * step.
template <int GS, bool ROW = (GS == 2), int FUSED_MAX = 16>
__device__ void group_sequence_backward(const float* __restrict__ xp, const float* __restrict__ wT,
                                        const float* __restrict__ hseq, const float* __restrict__ cseq,
                                        const float* __restrict__ dhseq, float* __restrict__ dxp,
                                        float* __restrict__ dw, int64_t wsize, int H, int frames, int B,
                                        int dirs, int first, int n) {
    constexpr int P = backward_ring<GS>();
    constexpr bool FUSED = GS <= FUSED_MAX;               // d(W_hh) summed inside the walk: 4 GS registers
    const int j = threadIdx.x % GS;
    const int slot = threadIdx.x / GS;
    if ((int)(threadIdx.x & ~31u) / GS >= n) return;
    const bool active = slot < n && j < H;
    const int q = first + (slot < n ? slot : 0);
    const int G = 4 * H;
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    // offsets from the walk's first position in 32 bits (the wrapper checks the range)
    const int xrow = B * G, hrow = B * dirs * H;
    const int xstep = d ? -xrow : xrow, hstep = d ? -hrow : hrow;
    const int p0 = d ? frames - 1 : 0;
    const int64_t xbase = ((int64_t)td * frames + p0) * xrow + (int64_t)b * G;
    const float* row = xp + xbase;
    float* drow = dxp + xbase;
    const int64_t hbase = ((int64_t)t * frames + p0) * hrow + (int64_t)b * dirs * H + d * H + j;
    const float* hs = hseq + hbase;
    const float* cs = cseq + hbase;
    const float* dhs = dhseq + hbase;

    float W[4][GS];                      // rows gate H + j of W_hh, scaled as K5 scales them
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k)
            W[gate][k] = (active && k < H)
                ? gate_scale(gate) * __ldg(wT + (int64_t)td * H * G + (int64_t)k * G + gate * H + j) : 0.f;

    // walk index i's inputs: projections, dh, c_prev, h_prev; with `clamp`, indices past the walk's last
    // step load that step (the main rounds never reach it and skip the clamps)
    auto load = [&](int i, float (&r)[7], bool clamp) {
        const int u = frames - 1 - (clamp ? min(i, frames - 1) : i), up = clamp ? max(u - 1, 0) : u - 1;
        float x4[4];
        load_projections<GS, ROW>(row + u * xstep, j, H, active, x4);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) r[gate] = x4[gate];
        r[4] = active ? __ldg(dhs + u * hstep) : 0.f;
        const float cpv = active ? __ldg(cs + up * hstep) : 0.f, hpv = active ? __ldg(hs + up * hstep) : 0.f;
        r[5] = (!clamp || u > 0) ? cpv : 0.f;                  // unclamped rounds stop at u = 1
        r[6] = (!clamp || u > 0) ? hpv : 0.f;
        prefetch_l2(row + (frames - 1 - min(i + AHEAD, frames - 1)) * xstep);
    };
    float ring[P][7];
#pragma unroll
    for (int v = 0; v < P; ++v) load(v, ring[v], true);
    float dh_rec = 0.f, dc_rec = 0.f;
    float acc[4][FUSED ? GS : 1];
    if (FUSED)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
#pragma unroll
            for (int k = 0; k < GS; ++k) acc[gate][FUSED ? k : 0] = 0.f;

    // A step in two halves: prep forms from the ring what does not wait on dh_rec (the recomputed gates, the
    // gradient's factors, the shuffled h_prev that d(W_hh) takes), chain carries dh_rec and dc_rec. Each
    // step preps the next one beside its own chain, so that the next step's activations (ten MUFU
    // operations) overlap this step's dependent chain.
    struct Prep {
        CellFactors a;
        float dho, hk[FUSED ? GS : 1];
    };
    auto prep = [&](const float (&r)[7], float c, Prep& q) {
        float hk[GS];
#pragma unroll
        for (int k = 0; k < GS; ++k) hk[k] = GS == 1 ? r[6] : (k < H ? __shfl_sync(0xffffffffu, r[6], k, GS) : 0.f);
        float z[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) z[gate] = row_sum<GS>(r[gate], gate_scale(gate), hk, W[gate]);
        q.a = cell_factors_(z, c, r[5]);
        q.dho = r[4];
        if (FUSED)
#pragma unroll
            for (int k = 0; k < GS; ++k) q.hk[FUSED ? k : 0] = hk[k];
    };
    Prep cur, next;
    prep(ring[0], active ? __ldg(cs + (frames - 1) * hstep) : 0.f, cur);

    // step i from cur, with the ring slot v it came from (its c_prev is the next step's c) and slot w of step
    // i + 1; slot v then takes step i + P
    auto step = [&](int v, int w, int i, bool clamp) {
        const int u = frames - 1 - i;
        prep(ring[w], ring[v][5], next);
        float dg[4];
        cell_chain_(cur.a, cur.dho + dh_rec, dc_rec, dg);
        if (active) {
            float* o = drow + u * xstep;
            if (GS == 1) *reinterpret_cast<float4*>(o) = make_float4(dg[0], dg[1], dg[2], dg[3]);
            else
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) o[gate * H + j] = dg[gate];
        }
        if (FUSED)
#pragma unroll
            for (int gate = 0; gate < 4; ++gate)
#pragma unroll
                for (int k = 0; k < GS; ++k)
                    acc[gate][FUSED ? k : 0] = fmaf(dg[gate], cur.hk[FUSED ? k : 0], acc[gate][FUSED ? k : 0]);
        float cv[GS];
        rec_contributions<GS>(W, dg, cv);
        dh_rec = reduce_scatter<GS>(cv, j);
        load(i + P, ring[v], clamp);
        cur = next;
    };
    int i0 = 0;
    for (; i0 + 2 * P < frames; i0 += P)                 // whole rounds whose loads stay in the walk
#pragma unroll
        for (int v = 0; v < P; ++v) step(v, (v + 1) % P, i0 + v, false);
    for (; i0 + P <= frames; i0 += P)                    // whole rounds, loads clamped
#pragma unroll
        for (int v = 0; v < P; ++v) step(v, (v + 1) % P, i0 + v, true);
#pragma unroll
    for (int v = 0; v < P; ++v)                           // the rest
        if (i0 + v < frames) step(v, (v + 1) % P, i0 + v, true);

    float* o = dw + (int64_t)b * wsize + (int64_t)td * H * G + j;
    if (FUSED) {
        if (active)
#pragma unroll
            for (int k = 0; k < GS; ++k)
                if (k < H)
#pragma unroll
                    for (int gate = 0; gate < 4; ++gate) o[(int64_t)k * G + gate * H] = acc[gate][FUSED ? k : 0];
        return;
    }
#ifndef K5B_NO_DW_PASS
    // d(W_hh^T)[k][gate H + j] of this sequence, a second ring walk over the d(xp) this lane wrote (plain
    // loads: written in this kernel) and h_prev: sum over forward steps u >= 1 of d(xp)[u] h_k[u - 1]
    float dacc[4][GS];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k) dacc[gate][k] = 0.f;
    auto load2 = [&](int i, float (&r)[5]) {
        const int u = frames - 1 - min(i, frames - 1), up = max(u - 1, 0);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) r[gate] = active ? drow[u * xstep + gate * H + j] : 0.f;
        const float hpv = active ? __ldg(hs + up * hstep) : 0.f;
        r[4] = u > 0 ? hpv : 0.f;
    };
    float ring2[P][5];
#pragma unroll
    for (int v = 0; v < P; ++v) load2(v, ring2[v]);
    auto sum = [&](float (&r)[5], int i) {
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            const float hk = k < H ? __shfl_sync(0xffffffffu, r[4], k, GS) : 0.f;
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) dacc[gate][k] = fmaf(r[gate], hk, dacc[gate][k]);
        }
        load2(i + P, r);
    };
    for (i0 = 0; i0 + P <= frames; i0 += P)
#pragma unroll
        for (int v = 0; v < P; ++v) sum(ring2[v], i0 + v);
#pragma unroll
    for (int v = 0; v < P; ++v)
        if (i0 + v < frames) sum(ring2[v], i0 + v);
    if (active)
#pragma unroll
        for (int k = 0; k < GS; ++k)
            if (k < H)
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) o[(int64_t)k * G + gate * H] = dacc[gate][k];
#endif
}

// Dynamic shared memory of K5b's block path (floats): with W_hh held, W_hh as K5 holds it (H unit_stride(Hp)),
// then h_prev double-buffered (2 Hp), the gate gradients double-buffered (2 x 4 Hp, gate-major), dh_rec and
// dc_rec (Hp each), all zero past H: kernels/lstm_recurrence.py::_block_smem.
// A block walks sequence q backward, thread tid owning units tid, tid + THREADS, ...: their four gate rows, the
// cells' backward and dh_rec of each. Walk index i: forward step u = frames - 1 - i.
template <bool W_SMEM>
__device__ void block_sequence_backward(const float* __restrict__ xp, const float* __restrict__ wT,
                                        const float* __restrict__ hseq, const float* __restrict__ cseq,
                                        const float* __restrict__ dhseq, float* __restrict__ dxp,
                                        float* __restrict__ dw, int64_t wsize, int H, int frames, int B,
                                        int dirs, int q, float* smem) {
    const int Hp = padded_h(H), WS = unit_stride(Hp), G = 4 * H;
    float* ws = smem;                                          // [H][WS] when W_SMEM
    float* hb = smem + (W_SMEM ? H * WS : 0);                  // [2][Hp]: h_prev of the step
    float* dgs = hb + 2 * Hp;                                  // [2][4 Hp]: the step's gate gradients
    float* dhr = dgs + 8 * Hp;                                 // [Hp]: dh_rec
    float* dcr = dhr + Hp;                                     // [Hp]: dc_rec
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const int64_t xrow = (int64_t)B * G, hrow = (int64_t)B * dirs * H;
    const int64_t xstep = d ? -xrow : xrow, hstep = d ? -hrow : hrow;
    const int p0 = d ? frames - 1 : 0;
    const int64_t xbase = ((int64_t)td * frames + p0) * xrow + (int64_t)b * G;
    const float* x = xp + xbase;
    float* dx = dxp + xbase;
    const int64_t hbase = ((int64_t)t * frames + p0) * hrow + (int64_t)b * dirs * H + d * H;
    const float* hs = hseq + hbase;
    const float* cs = cseq + hbase;
    const float* dhs = dhseq + hbase;
    const float* w = wT + (int64_t)td * H * G;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

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
    for (int e = tid; e < 2 * Hp; e += THREADS) {              // h_prev of the first backward step, u = frames - 1
        const int jj = e % Hp;
        hb[e] = (e < Hp && jj < H && frames >= 2) ? __ldg(hs + (frames - 2) * hstep + jj) : 0.f;
    }
    for (int e = tid; e < 10 * Hp; e += THREADS) dgs[e] = 0.f;  // the gradients' padding, dh_rec and dc_rec
    __syncthreads();

    for (int i = 0; i < frames; ++i) {
        const int u = frames - 1 - i, par = i & 1;
        const float* hcur = hb + par * Hp;                     // h[u - 1]
        float* hnext = hb + (par ^ 1) * Hp;                    // h[u - 2], for the next step
        float* dgc = dgs + par * 4 * Hp;
        for (int j = tid; j < H; j += THREADS) {
            float acc[4], z[4], dg[4];
            block_row_sums<W_SMEM>(ws + j * WS, w, j, H, Hp, hcur, acc);
            const float* xu = x + u * xstep + j;
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) z[gate] = (__ldg(xu + gate * H) + acc[gate]) * gate_scale(gate);
            const float c = __ldg(cs + u * hstep + j), cp = u > 0 ? __ldg(cs + (u - 1) * hstep + j) : 0.f;
            float dcj = dcr[j];
            cell_chain_(cell_factors_(z, c, cp), __ldg(dhs + u * hstep + j) + dhr[j], dcj, dg);
            dcr[j] = dcj;
            float* o = dx + u * xstep + j;
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                dgc[gate * Hp + j] = dg[gate];
                o[gate * H] = dg[gate];
            }
            hnext[j] = u >= 2 ? __ldg(hs + (u - 2) * hstep + j) : 0.f;
        }
        __syncthreads();                        // the step's gate gradients and the next step's h_prev are in
        if (W_SMEM) {
            // dh_rec_j = sum over gates and units r of W_hh[gate H + r][j] dg_gate(r): column j, one sum a gate,
            // the gradients read 16 bytes at a time (zero past H, where the row index stays on row H - 1)
            for (int j = tid; j < H; j += THREADS) {
                float sg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
                for (int r4 = 0; r4 < Hp / 4; ++r4) {
                    float4 g4[4];
#pragma unroll
                    for (int gate = 0; gate < 4; ++gate)
                        g4[gate] = reinterpret_cast<const float4*>(dgc + gate * Hp)[r4];
                    const float* w0 = ws + 4 * r4 * WS + j;
                    const int last = H - 1 - 4 * r4;
                    const int w1 = min(1, last) * WS, w2 = min(2, last) * WS, w3 = min(3, last) * WS;
#pragma unroll
                    for (int gate = 0; gate < 4; ++gate) {
                        sg[gate] = fmaf(w0[gate * Hp], g4[gate].x, sg[gate]);
                        sg[gate] = fmaf(w0[w1 + gate * Hp], g4[gate].y, sg[gate]);
                        sg[gate] = fmaf(w0[w2 + gate * Hp], g4[gate].z, sg[gate]);
                        sg[gate] = fmaf(w0[w3 + gate * Hp], g4[gate].w, sg[gate]);
                    }
                }
                dhr[j] = (sg[0] + sg[1]) + (sg[2] + sg[3]);
            }
        } else {
            // a warp per unit j: its lanes across row j of W^T (coalesced), then a shuffle reduction
            for (int j = warp; j < H; j += THREADS / 32) {
                float sacc = 0.f;
#pragma unroll
                for (int gate = 0; gate < 4; ++gate)
                    for (int k = lane; k < H; k += 32)
                        sacc = fmaf(__ldg(w + (int64_t)j * G + gate * H + k), dgc[gate * Hp + k], sacc);
#pragma unroll
                for (int off = 16; off; off >>= 1) sacc += __shfl_xor_sync(0xffffffffu, sacc, off);
                if (lane == 0) dhr[j] = sacc;
            }
        }
        // no second barrier: dhr[j] is next read after the next step's barrier on the L2 path, by its own
        // thread on the held path; dgs[par] is written again two steps on, after the next step's barrier
        if (!W_SMEM) __syncthreads();
    }
#ifndef K5B_NO_DW_PASS
    __syncthreads();                                           // every d(xp) of the sequence is in; W_hh is free
    // d(W_hh^T)[k][r] of this sequence: sum over forward steps u >= 1 of d(xp)[u][r] h_k[u - 1]; thread r0 +
    // tid takes its rows against KC columns of h at a time. With W_hh held, h_prev is staged in its place,
    // FC steps at a time in rows of Hp floats (zero past H), and read 16 bytes at a time
    constexpr int ROWS = 4, KC = 16;
    const int FC = W_SMEM ? (H * WS) / Hp : 0;                 // steps of h_prev the freed space holds
    auto stage = [&](int u0, int nu) {                         // h_prev of forward steps u0 .. u0 + nu - 1
        for (int e = tid; e < nu * Hp; e += THREADS) {
            const int uu = e / Hp, k = e % Hp;
            ws[e] = k < H ? __ldg(hs + (u0 + uu - 1) * hstep + k) : 0.f;
        }
    };
    const bool one_chunk = W_SMEM && frames - 1 <= FC;        // staged once for every tile (bark-262: 176 steps)
    if (one_chunk) {
        stage(1, frames - 1);
        __syncthreads();
    }
    float* o = dw + (int64_t)b * wsize + (int64_t)td * H * G;
    for (int r0 = 0; r0 < G; r0 += ROWS * THREADS)
        for (int k0 = 0; k0 < H; k0 += KC) {
            float acc[ROWS][KC];
#pragma unroll
            for (int k = 0; k < ROWS; ++k)
#pragma unroll
                for (int c = 0; c < KC; ++c) acc[k][c] = 0.f;
            auto rows = [&](int u, const float (&hk)[KC]) {
#pragma unroll
                for (int k = 0; k < ROWS; ++k) {
                    const int r = r0 + tid + k * THREADS;
                    const float g = r < G ? dx[u * xstep + r] : 0.f;
#pragma unroll
                    for (int c = 0; c < KC; ++c) acc[k][c] = fmaf(g, hk[c], acc[k][c]);
                }
            };
            if (W_SMEM) {
                for (int u0 = 1; u0 < frames; u0 += FC) {
                    const int nu = min(FC, frames - u0);
                    if (!one_chunk) {
                        __syncthreads();                       // the previous chunk's reads are done
                        stage(u0, nu);
                        __syncthreads();
                    }
#pragma unroll 2
                    for (int uu = 0; uu < nu; ++uu) {
                        float hk[KC];
                        const float4* h4 = reinterpret_cast<const float4*>(ws + uu * Hp + k0);
#pragma unroll
                        for (int c4 = 0; c4 < KC / 4; ++c4) {
                            const float4 v = k0 + 4 * c4 < Hp ? h4[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
                            hk[4 * c4] = v.x, hk[4 * c4 + 1] = v.y, hk[4 * c4 + 2] = v.z, hk[4 * c4 + 3] = v.w;
                        }
                        rows(u0 + uu, hk);
                    }
                }
            } else {
#pragma unroll 4
                for (int u = 1; u < frames; ++u) {
                    float hk[KC];
#pragma unroll
                    for (int c = 0; c < KC; ++c) hk[c] = k0 + c < H ? __ldg(hs + (u - 1) * hstep + k0 + c) : 0.f;
                    rows(u, hk);
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
#endif
}

// MIN_BLOCKS: the blocks an SM that ptxas plans registers for (launch bounds)
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
lstm_recurrence_backward_kernel(const float* __restrict__ xp, const float* __restrict__ wT,
                                const float* __restrict__ h, const float* __restrict__ c,
                                const float* __restrict__ dh, float* __restrict__ dxp, float* __restrict__ dw,
                                int64_t wsize, const int64_t* __restrict__ items) {
    extern __shared__ float4 smem4[];
    const int64_t* it = items + (int64_t)blockIdx.x * ITEM_FIELDS;
    const int H = (int)it[0], frames = (int)it[1], B = (int)it[2], dirs = (int)it[3];
    const float* x = xp + it[4];
    float* dx = dxp + it[4];
    const float* hh = h + it[5];
    const float* cc = c + it[5];
    const float* dd = dh + it[5];
    const float* w = wT + it[6];
    float* g = dw + it[6];
    const int first = (int)it[7], n = (int)it[8], lanes = (int)it[9];
    float* smem = reinterpret_cast<float*>(smem4);
    // held to 168 registers, GS = 16 sums d(W_hh) in a second walk (fused it spills 2 KB: 1.72 against 1.60
    // ms a layer offline); with 255 it fuses (2.80 against 3.21 realtime; H100, tools/k5b_variants.py)
    constexpr int F = MIN_BLOCKS >= 3 ? 8 : 16;
    switch (lanes) {                       // the work table's lanes: the power of two >= H, or a block
        case 1: return group_sequence_backward<1, false, F>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
        case 2: return group_sequence_backward<2, true, F>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
        case 4:
            if (H == 4) return group_sequence_backward<4, true, F>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs,
                                                                   first, n);
            return group_sequence_backward<4, false, F>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
        case 8: return group_sequence_backward<8, false, F>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
        case 16:
            return group_sequence_backward<16, false, F>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
        case 0: return block_sequence_backward<true>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, smem);
        default: return block_sequence_backward<false>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, smem);
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
// sequence's d(W_hh^T) in row b of dw, (B, wsize) floats. Where the table's shared memory lets three
// blocks share an SM, the build held to 168 registers runs (a little spilling in the wide group walks;
// on an H100 at batch 32 of 2 s offline 1.61 ms a layer against 1.87 with 255 registers, two blocks an
// SM); where W_hh held for a wide bucket leaves one block an SM, the build with all 255.
extern "C" int lstm_recurrence_backward(const void* xp, const void* wT, const void* h, const void* c,
                                        const void* dh, void* dxp, void* dw, int64_t wsize, const void* items,
                                        int64_t n_items, int64_t smem, void* stream) {
    if (n_items <= 0) return 0;
    int dev = 0, sm_bytes = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e != cudaSuccess) return (int)e;
    void (*kernel)(const float*, const float*, const float*, const float*, const float*, float*, float*, int64_t,
                   const int64_t*) = 3 * (smem + 1024) <= sm_bytes ? lstm_recurrence_backward_kernel<3>
                                                                    : lstm_recurrence_backward_kernel<1>;
    e = allow_smem((const void*)kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned int)n_items, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)wT, (const float*)h, (const float*)c, (const float*)dh, (float*)dxp,
        (float*)dw, wsize, (const int64_t*)items);
    return (int)cudaGetLastError();
}
