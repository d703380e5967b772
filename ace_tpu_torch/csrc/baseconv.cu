// Kernel K5: fast base conversion (Fast_base_conv, the reference's
// polynomial.c:755-808) of [O, n] residues modulo the old primes q_o into
// [new, n] residues modulo the new primes p_j:
//
//   out[j][c] = (sum_o shoup(x[o][c], hat_inv[o]) * mat[j][o]) mod p_j
//
// with the sum exact in 128 bits and a Barrett-128 reduction, so the words
// equal the plain version's (ops/baseconv.py base_conv_plain) wherever the
// sum fits: O * (max q_o - 1) * (max mat) < 2^128, which the wrapper
// (ops/baseconv.py) checks once per conversion. It replaces no TPU kernel:
// ace_tpu's base conversion is jnp code. On the card the plain version was
// an int64 ATen chain of some 500 launches per conversion (a Shoup
// pre-multiply, O steps of a 32-bit-halves 128-bit product and carry, a
// Barrett-128), each reading and writing [new, n] words.
//
// Bound on an H100: the bytes are the O source rows read once and the new
// target rows written once, (O + new) * n * 8; the work is O * new * n
// 64 x 64 -> 128-bit products (7 32-bit IMADs each) plus O * n Shoup
// products (10) and new * n Barrett-128 reductions (24). At [12 -> 34,
// 2^15] that is 12.1 MB (3.6 us at 3.35 TB/s) against 1.24e8 IMADs (7.4 us
// at 16.7e12 IMAD/s): the integer work bounds it.
//
// Design: one pass, no intermediate in device memory. A thread owns one
// column; a block owns 128 columns and a slice of R target rows (the
// grid's second dimension cuts the target rows into slices of R, at most
// K5_ROWS). The block stages its slice of `mat` and the per-row constants
// in shared memory, where every thread of a warp reads the same word (a
// broadcast). Each thread walks the O source words of its column once
// (coalesced loads), Shoup-multiplies each, and adds its product with
// each of the slice's matrix entries into that row's 128-bit accumulator,
// held in registers; then it reduces each accumulator and stores the
// slice's rows, coalesced. Every row of a slice is computed (a partial
// last slice reads zero matrix rows) and only the stores are guarded: a
// guard on the products made the compiler branch around each of them. R
// is a template argument, so the accumulators stay in registers: the
// launcher takes the fewest slices of at most K5_ROWS rows and the
// smallest R in K5_R that holds the rows' even share. K5_ROWS = 17 cuts
// the cell's 34 rows into two slices of 17 at 126 registers, four blocks
// per SM, so N = 2^15 is one wave of 512 blocks; variants of 4 to 12
// rows, or a guard on the products, took 21-29 us there against 19.9
// (H100). Any O, any number of target rows and any row length: the same
// launch serves mod-up, mod-down, the limb-sharded conversions (all of a
// digit's rows into this rank's rows) and the SPMD key switch's column
// shards.
#include <cuda_runtime.h>
#include "modarith.cuh"

typedef unsigned __int128 u128;

constexpr int K5_THREADS = 128;  // columns per block
constexpr int K5_ROWS = 17;      // most target rows per block
constexpr int K5_R[] = {1, 2, 4, 6, 8, 10, 12, 14, K5_ROWS};

// c: the packed constants, uint64 words
//   [q_o (O)][hat_inv_o (O)][hat_inv_o's Shoup word (O)][mat (new x O)]
//   [p_j (new)][mu_hi_j (new)][mu_lo_j (new)]
template <int R>
__global__ void __launch_bounds__(K5_THREADS)
k5_base_conv(const u64* __restrict__ x, const u64* __restrict__ c,
             u64* __restrict__ out, int O, int nnew, long long n) {
    extern __shared__ u64 sm[];
    u64* s_q = sm;                   // q_o, hat_inv_o, its Shoup word
    u64* s_inv = sm + O;
    u64* s_prec = sm + 2 * O;
    u64* s_mat = sm + 3 * O;         // [R][O], zero past `rows`
    u64* s_red = s_mat + R * O;      // p_j, mu_hi_j, mu_lo_j [3][R]

    const int j0 = blockIdx.y * R;
    const int rows = min(R, nnew - j0);
    for (int i = threadIdx.x; i < 3 * O; i += K5_THREADS) s_q[i] = c[i];
    for (int i = threadIdx.x; i < R * O; i += K5_THREADS) {
        int r = i / O;
        s_mat[i] = r < rows ? c[3 * O + (long long)(j0 + r) * O + (i - r * O)]
                            : 0ull;
    }
    if (threadIdx.x < 3 * R) {
        int k = threadIdx.x / R, r = threadIdx.x % R;
        s_red[threadIdx.x] =
            r < rows ? c[3 * O + (long long)nnew * O + k * nnew + j0 + r]
                     : 0ull;
    }
    __syncthreads();

    const long long col = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
    if (col >= n) return;
    u128 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0;
    const u64* xc = x + col;
#pragma unroll 4
    for (int o = 0; o < O; ++o) {
        u64 t = shoup_mul(__ldg(xc + (long long)o * n), s_inv[o], s_prec[o],
                          s_q[o]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += (u128)t * s_mat[r * O + o];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r < rows)
            out[(long long)(j0 + r) * n + col] = barrett_reduce_128(
                (u64)(acc[r] >> 64), (u64)acc[r], s_red[r], s_red[R + r],
                s_red[2 * R + r]);
    }
}

template <int R>
static int launch(const u64* x, const u64* c, u64* out, int O, int nnew,
                  long long n, cudaStream_t stream) {
    const size_t smem = sizeof(u64) * ((size_t)(3 + R) * O + 3 * R);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((n + K5_THREADS - 1) / K5_THREADS),
              (nnew + R - 1) / R);
    k5_base_conv<R><<<grid, K5_THREADS, smem, stream>>>(x, c, out, O, nnew,
                                                         n);
    return (int)cudaGetLastError();
}

extern "C" int ace_k5_base_conv(const void* x, const void* consts, void* out,
                                int num_old, int num_new, long long n,
                                void* stream) {
    if (num_old <= 0 || num_new <= 0 || n <= 0 || num_new > 65535 * K5_ROWS)
        return (int)cudaErrorInvalidValue;
    const int slices = (num_new + K5_ROWS - 1) / K5_ROWS;
    const int share = (num_new + slices - 1) / slices;
    int r = 0;
    while (K5_R[r] < share) ++r;
    const u64* xs = (const u64*)x;
    const u64* cs = (const u64*)consts;
    u64* o = (u64*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (K5_R[r]) {
        case 1: return launch<1>(xs, cs, o, num_old, num_new, n, st);
        case 2: return launch<2>(xs, cs, o, num_old, num_new, n, st);
        case 4: return launch<4>(xs, cs, o, num_old, num_new, n, st);
        case 6: return launch<6>(xs, cs, o, num_old, num_new, n, st);
        case 8: return launch<8>(xs, cs, o, num_old, num_new, n, st);
        case 10: return launch<10>(xs, cs, o, num_old, num_new, n, st);
        case 12: return launch<12>(xs, cs, o, num_old, num_new, n, st);
        case 14: return launch<14>(xs, cs, o, num_old, num_new, n, st);
        default: return launch<K5_ROWS>(xs, cs, o, num_old, num_new, n, st);
    }
}
