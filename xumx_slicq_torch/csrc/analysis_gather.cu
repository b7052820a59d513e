// K3: sliCQT analysis gather and weight, every bucket in one launch.
//
// Replaces the half-spectrum path of the JAX package's SliCQT.forward
// (xumx_slicq_tpu/ops/slicqt.py:678-689, tables from _build_forward_half,
// :594-619, and each bucket's fwd_w): for every row n = (batch, channel),
// slice s and flat coefficient k of bucket b (k = kstart_b + f * M_b + m)
//
//   t[n, s, k] = X[n, s, src[k]]            (conjugated where the entry says so)
//                * w[s % 2, k]
//
// written to the packed buffer in each bucket's (N, F_b, S, M_b) order:
//
//   out[S * (N * kstart_b + n * F_b * M_b) + (f * S + s) * M_b + m]
//
// which is the packed layout of SliCQT.layout (bucket b's block starts at
// N * S * kstart_b). X is the rFFT half spectrum (N, S, nh) complex64,
// read as interleaved (re, im) float32; the table holds one int4 per k:
// {src, or ~src where the gather reads the Hermitian mirror conj(X[nn - p]),
// kstart_b, M_b, F_b * M_b}. The M-point iFFT over m stays in cuFFT, on the
// packed buffer's bucket views.
//
// Bound: bytes. Each output is written once (8 B); the half spectrum is
// read once per row (8 B a position), the weights (16 B per k) and the
// table (16 B per k) once, and stay in L2 across rows and slices.
// Design: one thread per output element, consecutive threads on
// consecutive k, so the table and weight reads are coalesced, the writes
// coalesced along M within each frequency row, and a warp's spectrum reads
// fall on a few neighbouring positions of one row. blockIdx.y is the
// slice, blockIdx.z the row. The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <cstdint>

__global__ void analysis_gather_kernel(const float2* __restrict__ spec, int32_t nh,
                                       const int4* __restrict__ entries,
                                       const float2* __restrict__ w, int32_t K,
                                       float2* __restrict__ out, int32_t rows, int32_t n_slices) {
    int32_t k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    int32_t s = blockIdx.y;
    int32_t n = blockIdx.z;
    int4 e = __ldg(entries + k);
    int32_t src = e.x >= 0 ? e.x : ~e.x;
    float2 x = spec[((int64_t)n * n_slices + s) * nh + src];
    if (e.x < 0) x.y = -x.y;
    float2 wv = __ldg(w + (int64_t)(s & 1) * K + k);
    int32_t local = k - e.y;
    int32_t m = local % e.z;
    int64_t o = (int64_t)n_slices * ((int64_t)rows * e.y + (int64_t)n * e.w)
                + (int64_t)(local - m) * n_slices + (int64_t)s * e.z + m;
    out[o] = make_float2(x.x * wv.x - x.y * wv.y, x.x * wv.y + x.y * wv.x);
}

extern "C" int analysis_gather(const void* spec, int32_t nh, const void* entries, const void* w,
                               int32_t K, void* out, int32_t rows, int32_t n_slices, void* stream) {
    const int threads = 256;
    dim3 grid((unsigned int)((K + threads - 1) / threads), (unsigned int)n_slices, (unsigned int)rows);
    analysis_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)spec, nh, (const int4*)entries, (const float2*)w, K, (float2*)out, rows, n_slices);
    return (int)cudaGetLastError();
}
