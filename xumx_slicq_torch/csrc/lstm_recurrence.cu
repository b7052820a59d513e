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
//   W^T  (4, dirs, H, 4H)              W_hh transposed, read every step (L1-resident)
//
// Bound: neither bytes nor operations but the serial chain. A sequence's
// steps depend on each other, so the card's time is that of the longest
// sequence (85,264 steps at bark-262 with the default chunk, H = 1 offline
// and H = 2 realtime), times one step's dependent latency: the gate sums,
// the four gates' tanhf side by side, the cell update, tanhf(c) and the
// output product. The bytes (xp in, h out: 3.3 GB a layer at chunk batch
// 4) would take ~1 ms at 3.35 TB/s.
// Design: one launch runs every sequence of every bucket at once, so the
// layer costs the longest chain and not the sum of the chains.
//   * H <= 16 (all but one bucket offline, all but two realtime): a group
//     of GS lanes per sequence (GS the power of two >= H, so one lane per
//     sequence at H = 1), lane j owning unit j: its four rows of W_hh and
//     its c in registers, the gate sums unrolled at compile time (a template
//     per GS), h broadcast through the group by shuffles. A step then costs
//     one unit's arithmetic whatever H is. The loads of xp run PREFETCH
//     steps ahead of the chain in a register ring, and a prefetch into L2
//     runs further ahead, so device-memory latency stays off the chain.
//   * H > 16 (the wide low buckets, up to H = 86 realtime): a block per
//     sequence, one thread per gate row (at most 4 rows a thread), h shared
//     through shared memory, two barriers a step. Each thread reads its
//     rows of W^T through L1 every step (coalesced: consecutive threads read
//     consecutive rows), all its rows in one pass over h; no dynamic shared
//     memory is needed for the 118 KB W_hh of the realtime H = 86 bucket.
// Accurate tanhf (libm's, ~2 ulp; no fast math): errors have up to 85k
// steps to grow. The sigmoid is (1 + tanhf(x / 2)) / 2: on an H100 that
// cut a step of the longest chain from ~340 to ~210 ns against
// 1 / (1 + expf(-x)) with its IEEE division.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

#define THREADS 128
#define GROUP_H 16            // H up to this: a group of lanes per sequence; above: a block per sequence
#define MAX_ROWS 4            // gate rows per thread in the block path: H <= 128
#define MAX_H (MAX_ROWS * THREADS / 4)
#define ITEM_FIELDS 9         // H, frames, B, dirs, xp offset, h offset, W offset, first sequence, sequences

// sigmoid(x) = (1 + tanh(x / 2)) / 2, within ~1e-7 absolute of 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid_(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A group of GS lanes (a power of two, H <= GS <= 16) walks sequence q of a
// bucket: lane j < H owns unit j, that is gate rows j, H + j, 2H + j and
// 3H + j of W_hh (in registers) and the cell c_j; after each step the
// group's h is broadcast by shuffles. Lanes past H, or of a group past the
// last sequence, compute along (the shuffles need the whole warp) and
// neither load nor store.
template <int GS>
__device__ void group_sequence(const float* __restrict__ xp, const float* __restrict__ wT,
                               float* __restrict__ out, int H, int64_t frames, int B, int dirs, int first, int n) {
    constexpr int PREFETCH = 8;          // steps in registers ahead of the chain
    constexpr int L2_AHEAD = 32;         // steps prefetched into L2 ahead of that
    const int j = threadIdx.x % GS;
    const int slot = threadIdx.x / GS;
    if ((int)(threadIdx.x & ~31u) / GS >= n) return;      // a warp with no sequence: leave its scheduler free
    const bool active = slot < n && j < H;
    const int q = first + (slot < n ? slot : 0);
    const int G = 4 * H;
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const float* x = xp + (int64_t)td * frames * B * G + (int64_t)b * G + j;
    const int64_t xstride = (int64_t)B * G;
    float* o = out + (int64_t)t * frames * B * dirs * H + (int64_t)b * dirs * H + d * H + j;
    const int64_t ostride = (int64_t)B * dirs * H;

    float W[4][GS];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k)
            W[gate][k] = (active && k < H) ? __ldg(wT + (int64_t)td * H * G + (int64_t)k * G + gate * H + j) : 0.f;

    float ring[PREFETCH][4];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
        const int64_t p = d ? frames - 1 - u : u;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
            ring[u][gate] = (active && u < frames) ? __ldg(x + p * xstride + gate * H) : 0.f;
    }
    float h = 0.f, c = 0.f;
    for (int64_t s0 = 0; s0 < frames; s0 += PREFETCH) {
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
            const int64_t s = s0 + u;
            if (s >= frames) break;                        // the same for the whole warp: one bucket
            float a[4];
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) a[gate] = ring[u][gate];
            const int64_t sn = s + PREFETCH;
            if (active && sn < frames) {
                const int64_t pn = d ? frames - 1 - sn : sn;
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) ring[u][gate] = __ldg(x + pn * xstride + gate * H);
                const int64_t sf = sn + L2_AHEAD;
                if (sf < frames) prefetch_l2(x + (d ? frames - 1 - sf : sf) * xstride);
            }
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k = 0; k < GS; ++k) {
                const float hk = GS == 1 ? h : __shfl_sync(0xffffffffu, h, k, GS);
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) acc[gate] = fmaf(hk, W[gate][k], acc[gate]);
            }
            const float ig = sigmoid_(a[0] + acc[0]), fg = sigmoid_(a[1] + acc[1]);
            const float gg = tanhf(a[2] + acc[2]), og = sigmoid_(a[3] + acc[3]);
            c = fg * c + ig * gg;
            h = og * tanhf(c);
            if (active) o[(d ? frames - 1 - s : s) * ostride] = h;
        }
    }
}

// A block walks sequence q of a bucket with hidden size H > GROUP_H: thread r owns
// gate rows r, r + THREADS, ...; thread j < H owns unit j's cell.
__device__ void block_sequence(const float* __restrict__ xp, const float* __restrict__ wT,
                               float* __restrict__ out, int H, int64_t frames, int B, int dirs, int q,
                               float* gates, float* hs) {
    constexpr int PREFETCH = 4;
    const int G = 4 * H;
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const float* x = xp + (int64_t)td * frames * B * G + (int64_t)b * G;
    const int64_t xstride = (int64_t)B * G;
    float* o = out + (int64_t)t * frames * B * dirs * H + (int64_t)b * dirs * H + d * H;
    const int64_t ostride = (int64_t)B * dirs * H;
    const float* w = wT + (int64_t)td * H * G;
    const int tid = threadIdx.x;

    for (int j = tid; j < H; j += THREADS) hs[j] = 0.f;
    float c = 0.f;
    float ring[PREFETCH][MAX_ROWS];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u)
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) {
            const int r = tid + k * THREADS;
            const int64_t p = d ? frames - 1 - u : u;
            ring[u][k] = (u < frames && r < G) ? __ldg(x + p * xstride + r) : 0.f;
        }
    __syncthreads();
    for (int64_t s0 = 0; s0 < frames; s0 += PREFETCH) {
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
            const int64_t s = s0 + u;
            if (s >= frames) break;                        // uniform across the block
            const int64_t sn = s + PREFETCH;
            const int64_t pn = d ? frames - 1 - sn : sn;
            // all of a thread's rows in one pass over h: one shared read of h_j
            // feeds up to MAX_ROWS independent multiply-add chains
            float acc[MAX_ROWS];
#pragma unroll
            for (int k = 0; k < MAX_ROWS; ++k) acc[k] = 0.f;
#pragma unroll 2
            for (int j = 0; j < H; ++j) {
                const float hj = hs[j];
                const float* wj = w + (int64_t)j * G + tid;
#pragma unroll
                for (int k = 0; k < MAX_ROWS; ++k)
                    if (tid + k * THREADS < G) acc[k] = fmaf(hj, __ldg(wj + k * THREADS), acc[k]);
            }
#pragma unroll
            for (int k = 0; k < MAX_ROWS; ++k) {
                const int r = tid + k * THREADS;
                if (r < G) {
                    const float gate = ring[u][k] + acc[k];
                    gates[r] = (r >= 2 * H && r < 3 * H) ? tanhf(gate) : sigmoid_(gate);
                    if (sn < frames) {
                        ring[u][k] = __ldg(x + pn * xstride + r);
                        const int64_t sf = sn + 16;                // into L2 ahead of the register ring
                        if (sf < frames) prefetch_l2(x + (d ? frames - 1 - sf : sf) * xstride + r);
                    }
                }
            }
            __syncthreads();                               // every gate of step s is in, h is no longer read
            if (tid < H) {
                c = gates[H + tid] * c + gates[tid] * gates[2 * H + tid];
                const float hv = gates[3 * H + tid] * tanhf(c);
                hs[tid] = hv;
                o[(d ? frames - 1 - s : s) * ostride + tid] = hv;
            }
            __syncthreads();                               // h of step s is in before step s + 1 reads it
        }
    }
}

__global__ void __launch_bounds__(THREADS)
lstm_recurrence_kernel(const float* __restrict__ xp, const float* __restrict__ wT, float* __restrict__ out,
                       const int64_t* __restrict__ items) {
    __shared__ float gates[4 * MAX_H];
    __shared__ float hs[MAX_H];
    const int64_t* it = items + (int64_t)blockIdx.x * ITEM_FIELDS;
    const int H = (int)it[0], B = (int)it[2], dirs = (int)it[3];
    const int64_t frames = it[1];
    const float* x = xp + it[4];
    float* o = out + it[5];
    const float* w = wT + it[6];
    const int first = (int)it[7], n = (int)it[8];
    if (H > GROUP_H) block_sequence(x, w, o, H, frames, B, dirs, first, gates, hs);
    else if (H == 1) group_sequence<1>(x, w, o, H, frames, B, dirs, first, n);
    else if (H == 2) group_sequence<2>(x, w, o, H, frames, B, dirs, first, n);
    else if (H <= 4) group_sequence<4>(x, w, o, H, frames, B, dirs, first, n);
    else if (H <= 8) group_sequence<8>(x, w, o, H, frames, B, dirs, first, n);
    else group_sequence<16>(x, w, o, H, frames, B, dirs, first, n);
}

extern "C" int lstm_recurrence(const void* xp, const void* wT, void* out, const void* items, int64_t n_items,
                               void* stream) {
    if (n_items <= 0) return 0;
    lstm_recurrence_kernel<<<(unsigned int)n_items, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)wT, (float*)out, (const int64_t*)items);
    return (int)cudaGetLastError();
}
