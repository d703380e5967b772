// Kernel K6: the plaintext-message lift of the hoisted MAC bundles
// (ckks/evaluator.py Evaluator._mac_msgs): R signed int64 messages [R, n]
// to their canonical residues [R, LK, n] at LK moduli q_l,
//
//   out[r][l][c] = msg[r][c] mod q_l, in [0, q_l),
//
// word for word what the plain version (ops/lift.py lift_msgs_plain) and
// encoder._signed_to_rns give. The magnitude |msg| is taken as an
// unsigned word (INT64_MIN's is 2^63), reduced by Barrett-128 with a zero
// high word, quot = hi(v * mu_hi) + carry(lo(v * mu_hi) + hi(v * mu_lo)),
// r = v - quot * q and two conditional subtractions, as ops/modops.py
// mod_u64 does; a negative message with r != 0 gives q - r. It replaces no
// TPU kernel: ace_tpu's lift is jnp code inside its bundles. On the card
// the plain version was an int64 ATen chain of some 107 launches (the
// 64 x 64-bit products in 32-bit halves), each reading and writing
// [R, LK, n] words.
//
// Bound on an H100: the bytes are the messages read once and the residues
// written once, (R + R * LK) * n * 8; the work is R * LK * n reductions of
// two high and two low 64-bit products (14 32-bit IMADs). At [12, 22,
// 2^15] that is 72.3 MB (21.6 us at 3.35 TB/s) against 1.2e8 IMADs (7.3 us
// at 16.7e12 IMAD/s): the stores bound it.
//
// Design: one streaming pass. A thread owns two adjacent columns of one
// message: it loads them with one 16-byte load, keeps their magnitudes
// and signs in registers, and walks a slice of the limbs, storing each
// limb's two residues with one 16-byte store, so a warp writes 512
// contiguous bytes of a limb row at a time. The grid is (column blocks,
// messages, limb slices of K6_LIMBS): the slices give small R enough
// blocks to keep every SM storing, and a message row is read once per
// slice, from L2 after the first. The moduli and their mu words are read
// through __ldg: every thread of a warp reads the same word (a broadcast).
// No shared memory, no synchronisation, no allocation. The launch takes
// rows of even length and 16-byte aligned messages and output (the ring's
// n is a power of two; the wrapper, ops/lift.py, refuses an odd n and
// copies misaligned messages).
#include <cuda_runtime.h>
#include <cstdint>
#include "modarith.cuh"

constexpr int K6_THREADS = 128;  // threads per block
constexpr int K6_COLS = 2;       // adjacent columns per thread
constexpr int K6_LIMBS = 8;      // most limbs per block

__device__ __forceinline__ u64 lift_word(long long m, u64 q, u64 mu_hi,
                                         u64 mu_lo) {
    const u64 mag = m < 0 ? 0ull - (u64)m : (u64)m;
    const u64 r = mod_u64(mag, q, mu_hi, mu_lo);
    return (m < 0 && r != 0) ? q - r : r;
}

__global__ void __launch_bounds__(K6_THREADS)
k6_lift_msgs(const long long* __restrict__ msg, const u64* __restrict__ q,
             const u64* __restrict__ mu_hi, const u64* __restrict__ mu_lo,
             u64* __restrict__ out, int LK, long long n) {
    const long long col =
        ((long long)blockIdx.x * K6_THREADS + threadIdx.x) * K6_COLS;
    if (col >= n) return;
    const int r = blockIdx.y;
    const int l0 = blockIdx.z * K6_LIMBS;
    const int l1 = min(l0 + K6_LIMBS, LK);
    const longlong2 v =
        __ldg(reinterpret_cast<const longlong2*>(msg + (long long)r * n + col));
    u64* o = out + ((long long)r * LK + l0) * n + col;
#pragma unroll 4
    for (int l = l0; l < l1; ++l, o += n) {
        const u64 ql = __ldg(q + l), mh = __ldg(mu_hi + l),
                  ml = __ldg(mu_lo + l);
        ulonglong2 w;
        w.x = lift_word(v.x, ql, mh, ml);
        w.y = lift_word(v.y, ql, mh, ml);
        *reinterpret_cast<ulonglong2*>(o) = w;
    }
}

extern "C" int ace_k6_lift_msgs(const void* msg, const void* q,
                                const void* mu_hi, const void* mu_lo,
                                void* out, int R, int LK, long long n,
                                void* stream) {
    const int slices = (LK + K6_LIMBS - 1) / K6_LIMBS;
    const long long blocks =
        (n + K6_THREADS * K6_COLS - 1) / (K6_THREADS * K6_COLS);
    if (R <= 0 || LK <= 0 || n <= 0 || n % K6_COLS != 0 || R > 65535 ||
        slices > 65535 || blocks > 0x7fffffffLL ||
        (uintptr_t)msg % 16 != 0 || (uintptr_t)out % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks, R, slices);
    k6_lift_msgs<<<grid, K6_THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)msg, (const u64*)q, (const u64*)mu_hi,
        (const u64*)mu_lo, (u64*)out, LK, n);
    return (int)cudaGetLastError();
}
