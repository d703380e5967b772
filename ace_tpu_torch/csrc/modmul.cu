// Kernels K1 (Barrett product) and K2 (Shoup product) over [rows, n]
// uint64 residue planes, with per-row (per-limb) constants.
//
// K1 replaces ace_tpu/ops/pallas_modops.py barrett_mul (body
// _barrett_vals, driver _elementwise_call); K2 replaces
// pallas_modops.py shoup_mul (body _shoup_vals). The TPU kernels carry
// each 64-bit word as two u32 planes because the TPU vector unit has no
// 64-bit multiply; here one thread owns one element in native uint64_t
// and takes high products with __umul64hi.
//
// Bound on an H100: both are memory bound. K1 reads a and b and writes
// the product, 24 bytes per element, against about 31 32-bit
// multiply-adds; K2 reads x and writes the product, 16 bytes per element,
// against about 10. At [46, 32768] that is 36 MB (K1) or 24 MB (K2) of
// traffic, about 11 us or 7 us at 3.35 TB/s, against 3 us or 1 us of
// integer work at 16.7e12 32-bit IMAD/s (132 SMs x 64 lanes x 1.98 GHz,
// chip_smoke.py's IMAD_PER_S). The design answers the bound
// with the simplest streaming shape: consecutive threads on consecutive
// 8-byte words (coalesced 256-byte warps), constants read by row from
// L1, nothing staged in shared memory, one pass over the data.
#include <cuda_runtime.h>
#include "modarith.cuh"

__global__ void k1_barrett_mul(const u64* __restrict__ a,
                               const u64* __restrict__ b,
                               const u64* __restrict__ q,
                               const u64* __restrict__ mu_hi,
                               const u64* __restrict__ mu_lo,
                               u64* __restrict__ out, long long total, int logn,
                               int b_per_row) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        long long row = i >> logn;
        u64 x = a[i];
        u64 y = b_per_row ? b[row] : b[i];
        u64 hi = __umul64hi(x, y);
        u64 lo = x * y;
        out[i] = barrett_reduce_128(hi, lo, q[row], mu_hi[row], mu_lo[row]);
    }
}

__global__ void k2_shoup_mul(const u64* __restrict__ x,
                             const u64* __restrict__ w,
                             const u64* __restrict__ wp,
                             const u64* __restrict__ q,
                             u64* __restrict__ out, long long total, int logn) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        long long row = i >> logn;
        out[i] = shoup_mul(x[i], w[row], wp[row], q[row]);
    }
}

static int grid_for(long long total) {
    long long blocks = (total + 255) / 256;
    const long long cap = 132LL * 64;  // grid-stride beyond 64 blocks/SM
    return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

extern "C" int ace_k1_barrett_mul(const void* a, const void* b, const void* q,
                                  const void* mu_hi, const void* mu_lo,
                                  void* out, long long rows, int logn,
                                  int b_per_row, void* stream) {
    long long total = rows << logn;
    k1_barrett_mul<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
        (const u64*)a, (const u64*)b, (const u64*)q, (const u64*)mu_hi,
        (const u64*)mu_lo, (u64*)out, total, logn, b_per_row);
    return (int)cudaGetLastError();
}

extern "C" int ace_k2_shoup_mul(const void* x, const void* w, const void* wp,
                                const void* q, void* out, long long rows,
                                int logn, void* stream) {
    long long total = rows << logn;
    k2_shoup_mul<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
        (const u64*)x, (const u64*)w, (const u64*)wp, (const u64*)q,
        (u64*)out, total, logn);
    return (int)cudaGetLastError();
}
