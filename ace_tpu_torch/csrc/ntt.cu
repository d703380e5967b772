// Kernels K3 (forward negacyclic NTT) and K4 (inverse) over [L, N] uint64
// residue planes, one limb per grid row, position-identical to
// ops/ntt.py ntt_fwd / ntt_inv (Cooley-Tukey forward into bit-reversed
// "NTT form", Gentleman-Sande inverse with N^-1 folded into the first,
// pairwise stage; twiddles rou[bitrev(i)] = psi^i with Shoup precomputes).
//
// K3 replaces ace_tpu/ops/ntt4.py ntt4_fwd (_fwd_compute, _negact_cols,
// _make_kernel, _call); K4 replaces ntt4.py ntt4_inv (_inv_compute,
// _negags_cols). The TPU kernel holds a whole limb in VMEM; a limb at
// N = 2^15 is 256 KB, more than the 227 KB of shared memory a Hopper
// block can use. So each transform is two shared-memory passes over
// tiles of TILE = min(N, 4096) words (32 KB):
//   forward  pass A (strided):    the first S = log2(N/TILE) stages. Their
//            butterflies pair elements TILE apart, so the 2^S words
//            {c + t*TILE} of every column c form a closed set; a block
//            loads 2^S rows x TILE/2^S adjacent columns.
//            pass B (contiguous): the remaining log2(TILE) stages act on
//            aligned runs of TILE words; a block loads one run.
//   inverse  the same passes in the opposite order (B, then A).
// The butterflies, twiddles and their order are those of the 1-step
// ladder, and every operation returns a canonical residue, so the output
// equals ntt.ntt_fwd / ntt_inv word for word.
//
// Bound on an H100: memory. Per limb the transform reads N words and
// the two twiddle tables (2N words) and writes N words: 32 bytes per
// coefficient, 48 MB at [46, 32768], about 14 us at 3.35 TB/s. The
// integer work, N/2 log2 N Shoup butterflies of about 10 32-bit
// multiply-adds (IMAD) each, is about 7 us at 16.7e12 IMAD/s (132 SMs x
// 64 lanes x 1.98 GHz, chip_smoke.py's IMAD_PER_S). The design keeps the
// data traffic at two reads and two writes per word (one pair per pass)
// instead of one pair per stage, and reads the twiddles of each stage
// once per block through L1/L2.
#include <cuda_runtime.h>
#include "modarith.cuh"

#define TILE_LOG_MAX 12
#define TILE_MAX (1 << TILE_LOG_MAX)
#define THREADS 256

struct LimbArgs {
    const u64* rou;       // [Lfull, N] twiddles (inverse twiddles for K4)
    const u64* rou_prec;  // [Lfull, N] Shoup precomputes
    const u64* q;         // [Lfull]
    const u64* ninv;      // [Lfull] N^-1 mod q (K4 only)
    const u64* ninv_prec; // [Lfull]
    const long long* rows;// [L] table row of each data limb
};

// Both passes may run in place (in == out: K3's second pass, K4's
// second pass), so `in` and `out` are not __restrict__. That is safe
// because each block reads exactly the words it later writes, all of
// them into shared memory before the __syncthreads() that precedes its
// first butterfly, and no two blocks share a word.
//
// Strided pass: stages st in [0, S) (forward, increasing) or (S, 0]
// (inverse, decreasing). Block (x, l) owns columns [x*cols, (x+1)*cols)
// of the [2^S, N/2^S] view of limb l.
template <bool INV>
__global__ void __launch_bounds__(THREADS)
ntt_strided_pass(const u64* in, u64* out, LimbArgs t, int logn, int S) {
    __shared__ u64 s[TILE_MAX];
    const int log_tile = logn - S;  // == log2(TILE)
    const int logcols = log_tile - S;
    const int cols = 1 << logcols;
    const long long n = 1LL << logn;
    const long long stride = 1LL << log_tile;
    const int l = blockIdx.y;
    const long long g = t.rows[l];
    const u64* src = in + (long long)l * n;
    u64* dst = out + (long long)l * n;
    const u64* w = t.rou + g * n;
    const u64* wp = t.rou_prec + g * n;
    const u64 q = t.q[g];
    const long long c0 = (long long)blockIdx.x * cols;
    const int tile = 1 << log_tile;

    for (int e = threadIdx.x; e < tile; e += THREADS) {
        int r = e >> logcols, c = e & (cols - 1);
        s[e] = src[r * stride + c0 + c];
    }
    __syncthreads();
    const int nb = tile >> 1;
    for (int k = 0; k < S; ++k) {
        const int st = INV ? S - 1 - k : k;
        const int m = 1 << st;
        const int log_half = S - st - 1;  // half-span in rows
        for (int u = threadIdx.x; u < nb; u += THREADS) {
            int c = u & (cols - 1);
            int v = u >> logcols;
            int gi = v >> log_half;
            int r = v & ((1 << log_half) - 1);
            int ia = (((gi << (log_half + 1)) + r) << logcols) + c;
            int ib = ia + (1 << (log_half + logcols));
            u64 W = w[m + gi], WP = wp[m + gi];
            u64 x = s[ia], y = s[ib];
            if (!INV) {
                y = shoup_mul(y, W, WP, q);
                s[ia] = add_mod(x, y, q);
                s[ib] = sub_mod(x, y, q);
            } else {
                s[ia] = add_mod(x, y, q);
                s[ib] = shoup_mul(sub_mod(x, y, q), W, WP, q);
            }
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < tile; e += THREADS) {
        int r = e >> logcols, c = e & (cols - 1);
        dst[r * stride + c0 + c] = s[e];
    }
}

// Contiguous pass: stages st in [S, logn) on aligned runs of TILE words.
// The inverse's first stage (st = logn - 1) folds in N^-1.
template <bool INV>
__global__ void __launch_bounds__(THREADS)
ntt_contig_pass(const u64* in, u64* out, LimbArgs t, int logn, int S) {
    __shared__ u64 s[TILE_MAX];
    const int log_tile = logn - S;
    const int tile = 1 << log_tile;
    const long long n = 1LL << logn;
    const int l = blockIdx.y;
    const long long g = t.rows[l];
    const long long j0 = (long long)blockIdx.x * tile;
    const u64* src = in + (long long)l * n + j0;
    u64* dst = out + (long long)l * n + j0;
    const u64* w = t.rou + g * n;
    const u64* wp = t.rou_prec + g * n;
    const u64 q = t.q[g];

    for (int e = threadIdx.x; e < tile; e += THREADS) s[e] = src[e];
    __syncthreads();
    const int nb = tile >> 1;
    const int nst = logn - S;
    for (int k = 0; k < nst; ++k) {
        const int st = INV ? logn - 1 - k : S + k;
        const long long m = 1LL << st;
        const int log_half = logn - st - 1;
        const long long gbase = j0 >> (log_half + 1);
        const bool first = INV && k == 0;
        const u64 ni = first ? t.ninv[g] : 0, nip = first ? t.ninv_prec[g] : 0;
        for (int u = threadIdx.x; u < nb; u += THREADS) {
            int gl = u >> log_half;
            int r = u & ((1 << log_half) - 1);
            int ia = (gl << (log_half + 1)) + r;
            int ib = ia + (1 << log_half);
            u64 W = w[m + gbase + gl], WP = wp[m + gbase + gl];
            u64 x = s[ia], y = s[ib];
            if (!INV) {
                y = shoup_mul(y, W, WP, q);
                s[ia] = add_mod(x, y, q);
                s[ib] = sub_mod(x, y, q);
            } else {
                u64 sm = add_mod(x, y, q);
                u64 df = shoup_mul(sub_mod(x, y, q), W, WP, q);
                if (first) {
                    sm = shoup_mul(sm, ni, nip, q);
                    df = shoup_mul(df, ni, nip, q);
                }
                s[ia] = sm;
                s[ib] = df;
            }
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < tile; e += THREADS) dst[e] = s[e];
}

static int split(int logn) {
    return logn > TILE_LOG_MAX ? logn - TILE_LOG_MAX : 0;
}

extern "C" int ace_k3_ntt_fwd(const void* x, void* y, const void* rou,
                              const void* rou_prec, const void* q,
                              const void* rows, int L, int logn,
                              void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    LimbArgs t{(const u64*)rou, (const u64*)rou_prec, (const u64*)q,
               nullptr, nullptr, (const long long*)rows};
    const int S = split(logn);
    const int log_tile = logn - S;
    const u64* src = (const u64*)x;
    if (S > 0) {
        dim3 grid(1 << S, L);  // (N / TILE) column blocks of TILE/2^S
        ntt_strided_pass<false><<<grid, THREADS, 0, st>>>(src, (u64*)y, t,
                                                          logn, S);
        src = (const u64*)y;
    }
    dim3 grid(1 << (logn - log_tile), L);
    ntt_contig_pass<false><<<grid, THREADS, 0, st>>>(src, (u64*)y, t, logn,
                                                     S);
    return (int)cudaGetLastError();
}

extern "C" int ace_k4_ntt_inv(const void* x, void* y, const void* rou_inv,
                              const void* rou_inv_prec, const void* q,
                              const void* ninv, const void* ninv_prec,
                              const void* rows, int L, int logn,
                              void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    LimbArgs t{(const u64*)rou_inv, (const u64*)rou_inv_prec, (const u64*)q,
               (const u64*)ninv, (const u64*)ninv_prec,
               (const long long*)rows};
    const int S = split(logn);
    const int log_tile = logn - S;
    dim3 grid(1 << (logn - log_tile), L);
    ntt_contig_pass<true><<<grid, THREADS, 0, st>>>((const u64*)x, (u64*)y,
                                                    t, logn, S);
    if (S > 0) {
        dim3 grid2(1 << S, L);
        ntt_strided_pass<true><<<grid2, THREADS, 0, st>>>(
            (const u64*)y, (u64*)y, t, logn, S);
    }
    return (int)cudaGetLastError();
}
