// K1: sliCQT synthesis gather-assembly of the half spectrum.
//
// Replaces the XLA-fused assembly stage of the JAX package's
// SliCQT.backward (xumx_slicq_tpu/ops/slicqt.py:727-785 and the
// un-rotation of :807-809): for every (row n, slice s, position p < nh)
//
//   fr[n, s, p] = (sum_j w_re[p, j] * Re V[n, s, idx[p, j]]
//                  + i * sum_j w_im[p, j] * Im V[n, s, idx[p, j]]) * unrot[s % 2, p]
//
// where V is the flat raw synthesis spectrum of all buckets (bucket b's
// (F_b, M_b) block at a static offset, unpadded), idx/w_re/w_im the static
// (nh, O) entry table (mirror entries carry w_im = -w, i.e. a conjugate),
// and the sentinel idx == raw_len marks the end of a row's entries.
//
// Bound: bytes. Each output reads ~2 of its O = 4 entries (8 bytes each,
// scattered over the row's raw spectrum, which is 149 KB at bark-262 and
// stays in L1/L2 while a block's threads walk neighbouring p), plus the
// table and the phase, and writes 8 bytes. At the default chunk that is
// ~0.35 GB read + 0.17 GB written per stereo chunk, ~0.15 ms at 3.35 TB/s.
// Design: one thread per output element with consecutive threads on
// consecutive p, so the table, phase and output accesses are coalesced and
// the spectrum reads of a warp fall in a few cache lines; the loop stops at
// the first sentinel, so the ~49% sentinel entries cost no spectrum read.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

__global__ void synth_assembly_kernel(const float2* __restrict__ spec, int64_t raw_len,
                                      const int32_t* __restrict__ idx,
                                      const float* __restrict__ w_re,
                                      const float* __restrict__ w_im,
                                      const float2* __restrict__ unrot,
                                      float2* __restrict__ out,
                                      int64_t rows, int32_t n_slices, int32_t nh, int32_t O) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * nh) return;
    int64_t row = t / nh;                      // row = n * n_slices + s
    int32_t p = (int32_t)(t - row * nh);
    int32_t parity = (int32_t)(row % n_slices) & 1;
    const float2* src = spec + row * raw_len;
    float re = 0.f, im = 0.f;
    for (int32_t j = 0; j < O; ++j) {
        int32_t e = p * O + j;
        int32_t k = __ldg(idx + e);
        if (k >= raw_len) break;               // real entries first, then sentinels
        float2 v = src[k];
        re += __ldg(w_re + e) * v.x;
        im += __ldg(w_im + e) * v.y;
    }
    float2 ph = unrot[(int64_t)parity * nh + p];
    out[t] = make_float2(re * ph.x - im * ph.y, re * ph.y + im * ph.x);
}

extern "C" int synth_assembly(const void* spec, int64_t raw_len, const void* idx,
                              const void* w_re, const void* w_im, const void* unrot,
                              void* out, int64_t rows, int32_t n_slices, int32_t nh,
                              int32_t O, void* stream) {
    int64_t total = rows * nh;
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    synth_assembly_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)spec, raw_len, (const int32_t*)idx, (const float*)w_re,
        (const float*)w_im, (const float2*)unrot, (float2*)out, rows, n_slices, nh, O);
    return (int)cudaGetLastError();
}

// K1's backward: the cotangent of the flat raw spectra.
//
// Replaces XLA's autodiff of the assembly in the JAX package's train step
// (xumx_slicq_tpu/training.py:261-264, 274). With h = g * conj(unrot[s % 2, p]),
//
//   gV[n, s, k] = sum over the entries (p, j) with idx[p, j] = k of
//                 w_re[p, j] * Re h[p] + i * w_im[p, j] * Im h[p]
//
// gathered through the transposed table (tidx/tw_re/tw_im, (raw_len, W),
// sentinel tidx == nh after a value's real entries), built once on the
// host: a raw value is read by at most one positive piece and two mirror
// pieces (mu clamps at M-1), so W <= 3. Values whose targets all lie at
// p >= nh have only sentinels and get zero. No atomics: every output is
// written by exactly one thread, so the result is deterministic.
//
// Bound: bytes. The function reads g (8 B per half-spectrum value), writes
// gV (8 B per raw value) and reads the table once; one thread per
// (row, k) with consecutive threads on consecutive k, so the table and the
// output are coalesced and a warp's reads of g and of the phase fall on a
// few neighbouring positions of one row, which stay in L1/L2.

__global__ void synth_assembly_backward_kernel(const float2* __restrict__ g, int32_t nh,
                                               const int32_t* __restrict__ tidx,
                                               const float* __restrict__ tw_re,
                                               const float* __restrict__ tw_im,
                                               const float2* __restrict__ unrot,
                                               float2* __restrict__ out,
                                               int64_t rows, int32_t n_slices, int64_t raw_len,
                                               int32_t W) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * raw_len) return;
    int64_t row = t / raw_len;                 // row = n * n_slices + s
    int64_t k = t - row * raw_len;
    int32_t parity = (int32_t)(row % n_slices) & 1;
    const float2* src = g + row * nh;
    const float2* ph = unrot + (int64_t)parity * nh;
    float re = 0.f, im = 0.f;
    for (int32_t j = 0; j < W; ++j) {
        int64_t e = k * W + j;
        int32_t p = __ldg(tidx + e);
        if (p >= nh) break;                    // real entries first, then sentinels
        float2 gv = src[p];
        float2 u = __ldg(ph + p);
        re += __ldg(tw_re + e) * (gv.x * u.x + gv.y * u.y);   // Re(g conj(u))
        im += __ldg(tw_im + e) * (gv.y * u.x - gv.x * u.y);   // Im(g conj(u))
    }
    out[t] = make_float2(re, im);
}

extern "C" int synth_assembly_backward(const void* g, int32_t nh, const void* tidx,
                                       const void* tw_re, const void* tw_im, const void* unrot,
                                       void* out, int64_t rows, int32_t n_slices, int64_t raw_len,
                                       int32_t W, void* stream) {
    int64_t total = rows * raw_len;
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    synth_assembly_backward_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)g, nh, (const int32_t*)tidx, (const float*)tw_re, (const float*)tw_im,
        (const float2*)unrot, (float2*)out, rows, n_slices, raw_len, W);
    return (int)cudaGetLastError();
}
