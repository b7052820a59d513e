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
// In training the forward also writes the cell state c, packed like h
// (the `c` pointer; null when serving). The store is a template parameter:
// serving runs its own instantiation, which has no trace of it (a runtime
// test of the pointer cost the H = 2 chain a third of its speed).
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
template <int GS, bool CELL>
__device__ void group_sequence(const float* __restrict__ xp, const float* __restrict__ wT,
                               float* __restrict__ out, float* __restrict__ cout, int H, int64_t frames, int B,
                               int dirs, int first, int n) {
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
    const int64_t ooff = (int64_t)t * frames * B * dirs * H + (int64_t)b * dirs * H + d * H + j;
    float* o = out + ooff;
    float* oc = CELL ? cout + ooff : nullptr;
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
            if (active) {
                o[(d ? frames - 1 - s : s) * ostride] = h;
                if (CELL) oc[(d ? frames - 1 - s : s) * ostride] = c;
            }
        }
    }
}

// A block walks sequence q of a bucket with hidden size H > GROUP_H: thread r owns
// gate rows r, r + THREADS, ...; thread j < H owns unit j's cell.
template <bool CELL>
__device__ void block_sequence(const float* __restrict__ xp, const float* __restrict__ wT,
                               float* __restrict__ out, float* __restrict__ cout, int H, int64_t frames, int B,
                               int dirs, int q, float* gates, float* hs) {
    constexpr int PREFETCH = 4;
    const int G = 4 * H;
    const int b = q % B, td = q / B, d = td % dirs, t = td / dirs;
    const float* x = xp + (int64_t)td * frames * B * G + (int64_t)b * G;
    const int64_t xstride = (int64_t)B * G;
    const int64_t ooff = (int64_t)t * frames * B * dirs * H + (int64_t)b * dirs * H + d * H;
    float* o = out + ooff;
    float* oc = CELL ? cout + ooff : nullptr;
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
                if (CELL) oc[(d ? frames - 1 - s : s) * ostride + tid] = c;
            }
            __syncthreads();                               // h of step s is in before step s + 1 reads it
        }
    }
}

template <bool CELL>
__global__ void __launch_bounds__(THREADS)
lstm_recurrence_kernel(const float* __restrict__ xp, const float* __restrict__ wT, float* __restrict__ out,
                       float* __restrict__ cout, const int64_t* __restrict__ items) {
    __shared__ float gates[4 * MAX_H];
    __shared__ float hs[MAX_H];
    const int64_t* it = items + (int64_t)blockIdx.x * ITEM_FIELDS;
    const int H = (int)it[0], B = (int)it[2], dirs = (int)it[3];
    const int64_t frames = it[1];
    const float* x = xp + it[4];
    float* o = out + it[5];
    float* oc = CELL ? cout + it[5] : nullptr;
    const float* w = wT + it[6];
    const int first = (int)it[7], n = (int)it[8];
    if (H > GROUP_H) block_sequence<CELL>(x, w, o, oc, H, frames, B, dirs, first, gates, hs);
    else if (H == 1) group_sequence<1, CELL>(x, w, o, oc, H, frames, B, dirs, first, n);
    else if (H == 2) group_sequence<2, CELL>(x, w, o, oc, H, frames, B, dirs, first, n);
    else if (H <= 4) group_sequence<4, CELL>(x, w, o, oc, H, frames, B, dirs, first, n);
    else if (H <= 8) group_sequence<8, CELL>(x, w, o, oc, H, frames, B, dirs, first, n);
    else group_sequence<16, CELL>(x, w, o, oc, H, frames, B, dirs, first, n);
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
// Design: the forward's split.
//   * H <= 16: a group of GS lanes per sequence; lane j owns unit j: its
//     four rows of W_hh (for the recompute, in the forward's order of sums,
//     so the gates are the forward's bit for bit) and its column of W_hh
//     (the 4H-long row j of the packed W^T, for dh_rec), both in registers;
//     h_prev and each lane's four gate gradients broadcast by shuffles.
//     Loads run one step ahead in registers and further ahead into L2.
//     d(W_hh): lane j sums its four rows against h_prev, broadcast by
//     shuffles, 4 x GS sums in registers.
//   * H > 16: a block per sequence: gate rows recomputed one thread a row
//     (the forward's order), the cell in thread j < H, the gradients of the
//     4H rows in shared memory, and dh_rec with each warp taking units in
//     turn, its lanes splitting the 4H rows of W^T row j (coalesced) and
//     reducing by shuffles. Two barriers a step. d(W_hh): after a barrier,
//     thread r sums its gate rows against KC columns of h_prev at a time.

template <int GS>
__device__ void group_sequence_backward(const float* __restrict__ xp, const float* __restrict__ wT,
                                        const float* __restrict__ hseq, const float* __restrict__ cseq,
                                        const float* __restrict__ dhseq, float* __restrict__ dxp,
                                        float* __restrict__ dw, int64_t wsize, int H, int64_t frames, int B,
                                        int dirs, int first, int n) {
    constexpr int L2_AHEAD = 32;
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

    float W[4][GS], WT[4][GS];           // row gate*H + j of W_hh; column j of W_hh (row j of W^T)
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            W[gate][k] = (active && k < H) ? __ldg(w + (int64_t)k * G + gate * H + j) : 0.f;
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
            if (u - 1 - L2_AHEAD >= 0) {
                const int64_t pf = pos(u - 1 - L2_AHEAD);
#pragma unroll
                for (int gate = 0; gate < 4; ++gate) prefetch_l2(x + pf * xstride + gate * H);
                prefetch_l2(dh_ + pf * hstride);
                prefetch_l2(cp_ + pf * hstride);
                prefetch_l2(hp_ + pf * hstride);
            }
        }
        // the forward's gates, recomputed in its order of sums
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < GS; ++k) {
            const float hk = GS == 1 ? hp : __shfl_sync(0xffffffffu, hp, k, GS);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) acc[gate] = fmaf(hk, W[gate][k], acc[gate]);
        }
        const float ig = sigmoid_(a[0] + acc[0]), fg = sigmoid_(a[1] + acc[1]);
        const float gg = tanhf(a[2] + acc[2]), og = sigmoid_(a[3] + acc[3]);
        const float tc = tanhf(cc);
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
                                        int dirs, int q, float* gates, float* dgs, float* dhr) {
    constexpr int KC = 8;                                  // columns of d(W_hh^T) summed at once
    const int G = 4 * H;
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

    for (int j = tid; j < H; j += THREADS) dhr[j] = 0.f;
    float dc_rec = 0.f;
    for (int64_t u = frames - 1; u >= 0; --u) {
        const int64_t p = d ? frames - 1 - u : u;
        const int64_t pp = d ? p + 1 : p - 1;                  // step u - 1 of the forward walk
        float acc[MAX_ROWS];
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) acc[k] = 0.f;
        if (u > 0) {
#pragma unroll 2
            for (int j = 0; j < H; ++j) {
                const float hj = __ldg(hs + pp * hstride + j);
                const float* wj = w + (int64_t)j * G + tid;
#pragma unroll
                for (int k = 0; k < MAX_ROWS; ++k)
                    if (tid + k * THREADS < G) acc[k] = fmaf(hj, __ldg(wj + k * THREADS), acc[k]);
            }
        }
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) {
            const int r = tid + k * THREADS;
            if (r < G) {
                const float gate = __ldg(x + p * xstride + r) + acc[k];
                gates[r] = (r >= 2 * H && r < 3 * H) ? tanhf(gate) : sigmoid_(gate);
            }
        }
        __syncthreads();                                   // the gates of step u are in; dh_rec of step u + 1 too
        if (tid < H) {
            const float ig = gates[tid], fg = gates[H + tid], gg = gates[2 * H + tid], og = gates[3 * H + tid];
            const float tc = tanhf(__ldg(cs + p * hstride + tid));
            const float cp = u > 0 ? __ldg(cs + pp * hstride + tid) : 0.f;
            const float dh = __ldg(dhs + p * hstride + tid) + dhr[tid];
            const float dc = dc_rec + dh * og * (1.f - tc * tc);
            const float dg[4] = {dc * gg * ig * (1.f - ig), dc * cp * fg * (1.f - fg), dc * ig * (1.f - gg * gg),
                                 dh * tc * og * (1.f - og)};
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
                dgs[gate * H + tid] = dg[gate];
                dx[p * xstride + gate * H + tid] = dg[gate];
            }
            dc_rec = dc * fg;
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
    for (int k0 = 0; k0 < H; k0 += KC) {
        float acc[MAX_ROWS][KC];
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k)
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[k][c] = 0.f;
        for (int64_t v = 1; v < frames; ++v) {
            const int64_t p = d ? frames - 1 - v : v;
            const int64_t pp = d ? p + 1 : p - 1;
            float hk[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) hk[c] = k0 + c < H ? __ldg(hs + pp * hstride + k0 + c) : 0.f;
#pragma unroll
            for (int k = 0; k < MAX_ROWS; ++k) {
                const int r = tid + k * THREADS;
                if (r < G) {
                    const float g = dx[p * xstride + r];
#pragma unroll
                    for (int c = 0; c < KC; ++c) acc[k][c] = fmaf(g, hk[c], acc[k][c]);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < MAX_ROWS; ++k) {
            const int r = tid + k * THREADS;
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
    __shared__ float gates[4 * MAX_H];
    __shared__ float dgs[4 * MAX_H];
    __shared__ float dhr[MAX_H];
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
    const int first = (int)it[7], n = (int)it[8];
    if (H > GROUP_H)
        block_sequence_backward(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, gates, dgs, dhr);
    else if (H == 1) group_sequence_backward<1>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
    else if (H == 2) group_sequence_backward<2>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
    else if (H <= 4) group_sequence_backward<4>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
    else if (H <= 8) group_sequence_backward<8>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
    else group_sequence_backward<16>(x, w, hh, cc, dd, dx, g, wsize, H, frames, B, dirs, first, n);
}

// c: null when serving; in training the forward writes the cell state there, packed like out.
extern "C" int lstm_recurrence(const void* xp, const void* wT, void* out, void* c, const void* items,
                               int64_t n_items, void* stream) {
    if (n_items <= 0) return 0;
    if (c)
        lstm_recurrence_kernel<true><<<(unsigned int)n_items, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)xp, (const float*)wT, (float*)out, (float*)c, (const int64_t*)items);
    else
        lstm_recurrence_kernel<false><<<(unsigned int)n_items, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)xp, (const float*)wT, (float*)out, (float*)c, (const int64_t*)items);
    return (int)cudaGetLastError();
}

// K5b over the forward's work table: d(xp) from the forward's xp, W^T, h, c and the cotangent dh, and
// each sequence's d(W_hh^T) in row b of dw, (B, wsize) floats.
extern "C" int lstm_recurrence_backward(const void* xp, const void* wT, const void* h, const void* c,
                                        const void* dh, void* dxp, void* dw, int64_t wsize, const void* items,
                                        int64_t n_items, void* stream) {
    if (n_items <= 0) return 0;
    lstm_recurrence_backward_kernel<<<(unsigned int)n_items, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)xp, (const float*)wT, (const float*)h, (const float*)c, (const float*)dh, (float*)dxp,
        (float*)dw, wsize, (const int64_t*)items);
    return (int)cudaGetLastError();
}
