// Kernels K3 (forward negacyclic NTT) and K4 (inverse) over [L, N] uint64
// residue planes, position-identical to ops/ntt.py ntt_fwd_plain /
// ntt_inv_plain (Cooley-Tukey forward into bit-reversed "NTT form",
// Gentleman-Sande inverse with N^-1 folded into the first, pairwise
// stage; twiddles rou[bitrev(i)] = psi^i with Shoup precomputes).
//
// K3 replaces ace_tpu/ops/ntt4.py ntt4_fwd (_fwd_compute, _negact_cols,
// _make_kernel, _call); K4 replaces ntt4.py ntt4_inv (_inv_compute,
// _negags_cols). The TPU kernel holds a whole limb in VMEM.
//
// What bounds it on an H100. Per limb the transform reads N words and the
// two twiddle tables (2N words) and writes N words: 32 bytes per
// coefficient, 48 MB at [46, 32768], 14.4 us at 3.35 TB/s (the bound
// chip_smoke.py states). The design below moves each of those words
// between device memory and the SMs once. What it then runs into is
// integer issue: a butterfly's 64-bit Shoup product and two modular
// corrections compile to 37.5 SASS instructions (16.6 of them IMAD),
// and the whole card runs them at about 0.55 T butterflies/s, so the
// N/2 log2 N butterflies at [46, 32768] need about 20 us, more than the
// bytes (scripts/torch_ntt_sweep.py: its probe's loop gives the count
// and the rate, and it prints the kernels' SASS mix; PERF.md has the
// times).
//
// One launch, one thread-block cluster per limb. The C = 2^LC blocks of
// a cluster (grid (C, L)) each hold one contiguous chunk of M = N/C
// words in dynamic shared memory, so together they hold the limb (N =
// 2^15: 8 blocks of 32 KB, or 16 of 16 KB for a launch of a few limbs;
// N = 2^17: 8 of 128 KB). Stage st of the ladder pairs words N/2^(st+1)
// apart, so the first LC stages pair words of different chunks; for a
// column j < M the C words {r*M + j} are closed under them.
//   forward: each block loads M/C columns straight from device memory
//            (a warp reads 32 consecutive words of each row), runs the LC
//            cross-chunk stages in registers and scatters row r of each
//            column into block r's shared memory (distributed shared
//            memory); cluster.sync(); then the other log2 M stages on the
//            block's own chunk, which it stores as 16-byte vectors.
//   inverse: the mirror image: load the chunk (16-byte vectors), run its
//            log2 M stages (N^-1 folded into the first), cluster.sync(),
//            gather the columns over DSMEM, run the LC cross-chunk stages
//            and store.
// Register radix: the in-chunk stages go in groups of up to K = 3; a
// thread loads the 2^K words that a group's butterflies close over into
// registers, runs all the group's stages on them and writes them back:
// one __syncthreads() per K stages. The group's 2^K - 1 twiddles (and
// their Shoup precomputes) form 2^i consecutive, 2^i-aligned entries per
// stage i; the thread issues all their loads (16-byte for i >= 1) before
// its first butterfly. Radix 8 keeps a thread within 64 registers, so
// four 8-warp blocks share an SM (radix 16 needed 120-150 registers and
// measured slower). Shared memory is swizzled (word i at slot
// i ^ ((i >> K) & 15)), which keeps every 64-bit access of a half-warp on
// 16 different bank pairs for every set stride the groups use, and maps
// words i, i + 1 (i even) onto one aligned slot pair, so the 16-byte
// accesses of the chunk loads and stores are conflict-free too.
// tests/test_torch_ntt_schedule.py models this schedule in numpy.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "modarith.cuh"

namespace cg = cooperative_groups;

constexpr int K = 3;            // register radix: stages per shared-memory round
constexpr int LOGN_MAX = 17;    // N up to 2^17: 8 blocks of 128 KB
constexpr int CHUNK_LOG = 11;   // chunks of >= 2^11 words where N allows
constexpr int THREADS_MAX = 256;
constexpr int MIN_BLOCKS = 4;   // blocks per SM: __launch_bounds__ caps
                                // registers at 64, so 4 blocks of 8 warps
                                // fit on an SM

struct LimbArgs {
    const u64* rou;       // [Lfull, N] twiddles (inverse twiddles for K4)
    const u64* rou_prec;  // [Lfull, N] Shoup precomputes
    const u64* q;         // [Lfull]
    const u64* ninv;      // [Lfull] N^-1 mod q (K4 only)
    const u64* ninv_prec; // [Lfull]
    const long long* rows;// [L] table row of each data limb
};

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> K) & 15); }

// Words i and i + 1 (i even) of a swizzled chunk are the two halves of
// one aligned slot pair, swapped where bit K of i is set: one 16-byte
// shared-memory access moves both.
__device__ __forceinline__ void ld_pair(const u64* s, int i, u64& a,
                                        u64& b) {
    const int sl = swz(i);
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(s)[sl >> 1];
    a = (sl & 1) ? v.y : v.x;
    b = (sl & 1) ? v.x : v.y;
}

__device__ __forceinline__ void st_pair(u64* s, int i, u64 a, u64 b) {
    const int sl = swz(i);
    reinterpret_cast<ulonglong2*>(s)[sl >> 1] =
        (sl & 1) ? make_ulonglong2(b, a) : make_ulonglong2(a, b);
}

// A block may touch another's shared memory only once that block runs:
// the forward kernel arrives on the cluster barrier first thing and waits
// only before its first remote store, so its first loads overlap the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void ct_bfly(u64& x, u64& y, u64 w, u64 wp,
                                        u64 q) {
    const u64 t = shoup_mul(y, w, wp, q);
    y = sub_mod(x, t, q);
    x = add_mod(x, t, q);
}

__device__ __forceinline__ void gs_bfly(u64& x, u64& y, u64 w, u64 wp,
                                        u64 q) {
    const u64 s = add_mod(x, y, q);
    y = shoup_mul(sub_mod(x, y, q), w, wp, q);
    x = s;
}

// The LC cross-chunk stages on one column held in registers, x[r] the
// word of row r: stage st reads twiddle (1 << st) + (lo >> (LC - st)),
// loaded just before its butterflies so that only one stage's twiddles
// hold registers beside the C words.
template <bool INV, int LC>
__device__ __forceinline__ void cross_stages(u64 (&x)[1 << LC],
                                             const u64* w, const u64* wp,
                                             u64 q) {
    constexpr int C = 1 << LC;
#pragma unroll
    for (int k = 0; k < LC; ++k) {
        const int st = INV ? LC - 1 - k : k;
        const int h = C >> (st + 1);
#pragma unroll
        for (int jj = 0; jj < C / 2; ++jj) {
            const int lo = (jj / h) * 2 * h + jj % h;
            const int tw = (1 << st) + (lo >> (LC - st));
            if (!INV)
                ct_bfly(x[lo], x[lo + h], __ldg(w + tw), __ldg(wp + tw), q);
            else
                gs_bfly(x[lo], x[lo + h], __ldg(w + tw), __ldg(wp + tw), q);
        }
    }
}

// Stages [sa, sa + KK) on the block's chunk s (block b of the cluster).
// Set u = (G, r) holds the 2^KK words base + t * 2^ls, base = G * 2^(ls +
// KK) + r, r < 2^ls: exactly the words the group's butterflies mix.
// Stage st = sa + i of the set reads twiddles (1 << st) + (b << (st -
// lc)) + (G << i) + c, c < 2^i. FOLD: the inverse's top group, whose
// first stage (st = logn - 1) also multiplies by N^-1.
template <bool INV, int KK, bool FOLD>
__device__ __forceinline__ void stage_group(u64* s, const u64* w,
                                            const u64* wp, u64 q, int sa,
                                            int logn, int lc, int b, u64 ni,
                                            u64 nip) {
    const int ls = logn - sa - KK;
    const int nsets = 1 << (logn - lc - KK);
    for (int u = threadIdx.x; u < nsets; u += blockDim.x) {
        const int r = u & ((1 << ls) - 1);
        const int G = u >> ls;
        const int base = (G << (ls + KK)) + r;
        u64 W[1 << KK], WP[1 << KK];  // stage i's c-th twiddle at (1<<i)+c
#pragma unroll
        for (int i = 0; i < KK; ++i) {
            const int st = sa + i;
            const int o = (1 << st) + (b << (st - lc)) + (G << i);
            if (i == 0) {
                W[1] = __ldg(w + o);
                WP[1] = __ldg(wp + o);
            } else {
#pragma unroll
                for (int c = 0; c < (1 << i); c += 2) {
                    const ulonglong2 a =
                        __ldg(reinterpret_cast<const ulonglong2*>(w + o + c));
                    const ulonglong2 ap =
                        __ldg(reinterpret_cast<const ulonglong2*>(wp + o + c));
                    W[(1 << i) + c] = a.x;
                    W[(1 << i) + c + 1] = a.y;
                    WP[(1 << i) + c] = ap.x;
                    WP[(1 << i) + c + 1] = ap.y;
                }
            }
        }
        u64 v[1 << KK];
#pragma unroll
        for (int t = 0; t < (1 << KK); ++t) v[t] = s[swz(base + (t << ls))];
#pragma unroll
        for (int k = 0; k < KK; ++k) {
            const int i = INV ? KK - 1 - k : k;
            const int h = 1 << (KK - 1 - i);  // pair distance in the set
#pragma unroll
            for (int j = 0; j < (1 << (KK - 1)); ++j) {
                const int c = j >> (KK - 1 - i);
                const int lo = (c << (KK - i)) | (j & (h - 1));
                if (!INV) {
                    ct_bfly(v[lo], v[lo + h], W[(1 << i) + c],
                            WP[(1 << i) + c], q);
                } else {
                    gs_bfly(v[lo], v[lo + h], W[(1 << i) + c],
                            WP[(1 << i) + c], q);
                    if (FOLD && k == 0) {
                        v[lo] = shoup_mul(v[lo], ni, nip, q);
                        v[lo + h] = shoup_mul(v[lo + h], ni, nip, q);
                    }
                }
            }
        }
#pragma unroll
        for (int t = 0; t < (1 << KK); ++t) s[swz(base + (t << ls))] = v[t];
    }
}

template <bool INV, bool FOLD>
__device__ __forceinline__ void run_group(int kk, u64* s, const u64* w,
                                          const u64* wp, u64 q, int sa,
                                          int logn, int lc, int b, u64 ni,
                                          u64 nip) {
    switch (kk) {
    case 1: stage_group<INV, 1, FOLD>(s, w, wp, q, sa, logn, lc, b, ni, nip);
            break;
    case 2: stage_group<INV, 2, FOLD>(s, w, wp, q, sa, logn, lc, b, ni, nip);
            break;
    default: stage_group<INV, K, FOLD>(s, w, wp, q, sa, logn, lc, b, ni,
                                       nip);
    }
}

// The in-place case (in == out) is safe, so the data pointers are not
// __restrict__: every word of a limb is read, by some block of its
// cluster, before the cluster.sync() that precedes the first write.
// Device-memory accesses are consecutive across the threads of a warp:
// 16-byte vectors of two words for the chunks, 8-byte words for the
// columns (two columns a thread held 2C words in registers, spilled at
// C = 8 and halved the threads at work at C = 16: slower, PERF.md).
template <bool INV, int LC>
__global__ void __launch_bounds__(THREADS_MAX, MIN_BLOCKS)
ntt_cluster(const u64* in, u64* out, LimbArgs t, int logn) {
    extern __shared__ __align__(16) u64 s[];
    constexpr int C = 1 << LC;
    cg::cluster_group cluster = cg::this_cluster();
    const int b = (int)cluster.block_rank();
    const int lm = logn - LC;
    const int M = 1 << lm;
    const int cols = M >> LC;  // columns of this block in the cross phase
    const long long n = 1LL << logn;
    const int l = blockIdx.y;
    const long long g = t.rows[l];
    const u64* src = in + (long long)l * n;
    u64* dst = out + (long long)l * n;
    const u64* w = t.rou + g * n;
    const u64* wp = t.rou_prec + g * n;
    const u64 q = t.q[g];

    if (!INV) {
        cluster_arrive_relaxed();
        bool waited = false;
        for (int j = b * cols + threadIdx.x; j < (b + 1) * cols;
             j += blockDim.x) {
            u64 x[C];
#pragma unroll
            for (int r = 0; r < C; ++r) x[r] = src[r * M + j];
            cross_stages<false, LC>(x, w, wp, q);
            if (!waited) {
                cluster_wait();
                waited = true;
            }
#pragma unroll
            for (int r = 0; r < C; ++r)
                cluster.map_shared_rank(s, r)[swz(j)] = x[r];
        }
        if (!waited) cluster_wait();
        cluster.sync();
        int sa = LC;
        int kk = (lm - 1) % K + 1;
        while (sa < logn) {
            run_group<false, false>(kk, s, w, wp, q, sa, logn, LC, b, 0, 0);
            __syncthreads();
            sa += kk;
            kk = K;
        }
        u64* d = dst + (long long)b * M;
        for (int p = 2 * threadIdx.x; p < M; p += 2 * blockDim.x) {
            u64 a, c;
            ld_pair(s, p, a, c);
            *reinterpret_cast<ulonglong2*>(d + p) = make_ulonglong2(a, c);
        }
    } else {
        const u64 ni = t.ninv[g], nip = t.ninv_prec[g];
        const u64* c = src + (long long)b * M;
        for (int p = 2 * threadIdx.x; p < M; p += 2 * blockDim.x) {
            const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(c + p);
            st_pair(s, p, v.x, v.y);
        }
        __syncthreads();
        int hi = logn;
        while (hi > LC) {
            const int kk = hi - LC < K ? hi - LC : K;
            if (hi == logn)
                run_group<true, true>(kk, s, w, wp, q, hi - kk, logn, LC, b,
                                      ni, nip);
            else
                run_group<true, false>(kk, s, w, wp, q, hi - kk, logn, LC, b,
                                       0, 0);
            __syncthreads();
            hi -= kk;
        }
        cluster.sync();
        for (int j = b * cols + threadIdx.x; j < (b + 1) * cols;
             j += blockDim.x) {
            u64 x[C];
#pragma unroll
            for (int r = 0; r < C; ++r)
                x[r] = cluster.map_shared_rank(s, r)[swz(j)];
            cross_stages<true, LC>(x, w, wp, q);
#pragma unroll
            for (int r = 0; r < C; ++r) dst[r * M + j] = x[r];
        }
        // no block may leave while another still reads its chunk
        cluster.sync();
    }
}

// Threads per block: one set of 2^K words each per stage group (32 to
// 256).
static int threads_for(int lm) {
    const int sets = lm > K ? 1 << (lm - K) : 1;
    return sets < 32 ? 32 : (sets > THREADS_MAX ? THREADS_MAX : sets);
}

// The launch configuration of ntt_cluster<INV, LC> for L limbs of
// 2^logn words. The first launch of a shape raises the kernel's dynamic
// shared-memory limit to what the shape needs.
template <bool INV, int LC>
static cudaError_t prepare(int L, int logn, cudaStream_t st,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
    static size_t smem_set = 0;
    auto kern = ntt_cluster<INV, LC>;
    const int lm = logn - LC;
    const size_t smem = sizeof(u64) << lm;
    if (smem > smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e == cudaSuccess && LC > 3)  // 16 blocks: beyond portable
            e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        smem_set = smem;
    }
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(1 << LC, L);
    cfg->blockDim = dim3(threads_for(lm));
    cfg->dynamicSmemBytes = smem;
    cfg->stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << LC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return cudaSuccess;
}

// Clusters of this shape the card holds at once (0: it does not fit).
template <bool INV, int LC>
static cudaError_t max_clusters(int logn, int* count) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const cudaError_t e = prepare<INV, LC>(1, logn, 0, &cfg, attr);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveClusters(count, ntt_cluster<INV, LC>, &cfg);
}

// max_clusters, asked once per shape (0: the cluster does not fit).
template <bool INV, int LC>
static cudaError_t resident(int logn, int* count) {
    static int known[LOGN_MAX + 1];  // count + 1; 0: not asked yet
    if (known[logn] == 0) {
        int nc = 0;
        const cudaError_t e = max_clusters<INV, LC>(logn, &nc);
        if (e != cudaSuccess) return e;
        known[logn] = nc + 1;
    }
    *count = known[logn] - 1;
    return cudaSuccess;
}

template <bool INV, int LC>
static int launch(const u64* x, u64* y, LimbArgs t, int L, int logn,
                  cudaStream_t st) {
    int nc = 0;
    cudaError_t e = resident<INV, LC>(logn, &nc);
    if (e == cudaSuccess && nc == 0) e = cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    if (e == cudaSuccess) e = prepare<INV, LC>(L, logn, st, &cfg, attr);
    if (e == cudaSuccess)
        e = cudaLaunchKernelEx(&cfg, ntt_cluster<INV, LC>, x, y, t, logn);
    return (int)e;
}

// Blocks per cluster, 2^lc, for L limbs of 2^logn words. A chunk holds
// 2^CHUNK_LOG words or more: one block below N = 2^12, 8 from N = 2^14.
// From N = 2^15 a launch of a few limbs takes clusters of 16, a
// non-portable size, each spread over twice the SMs of a cluster of 8,
// as long as all L of them fit at one block per SM: L <= (clusters of 16
// resident at MIN_BLOCKS blocks per SM) / MIN_BLOCKS, 28 / 4 = 7 on an
// H100, one per GPC of 16 SMs or more. There that took 1 to 7 limbs from
// 0.015 to 0.011 ms and nothing off 8 limbs (PERF.md).
static cudaError_t cluster_log(int L, int logn, int* lc) {
    const int c = logn - CHUNK_LOG;
    *lc = c < 0 ? 0 : (c > 3 ? 3 : c);
    if (c < 4) return cudaSuccess;
    int k3 = 0, k4 = 0;
    cudaError_t e;
    if ((e = resident<false, 4>(logn, &k3)) != cudaSuccess ||
        (e = resident<true, 4>(logn, &k4)) != cudaSuccess)
        return e;
    if (L * MIN_BLOCKS <= (k3 < k4 ? k3 : k4)) *lc = 4;
    return cudaSuccess;
}

template <bool INV>
static int dispatch(const void* x, void* y, LimbArgs t, int L, int logn,
                    void* stream) {
    if (logn < 1 || logn > LOGN_MAX || L < 1 || L > 65535)
        return (int)cudaErrorInvalidValue;
    if (((uintptr_t)x | (uintptr_t)y) & 15)  // 16-byte vector accesses
        return (int)cudaErrorMisalignedAddress;
    int lc = 0;
    const cudaError_t e = cluster_log(L, logn, &lc);
    if (e != cudaSuccess) return (int)e;
    static int (*const by_lc[])(const u64*, u64*, LimbArgs, int, int,
                                cudaStream_t) = {
        launch<INV, 0>, launch<INV, 1>, launch<INV, 2>, launch<INV, 3>,
        launch<INV, 4>};
    return by_lc[lc]((const u64*)x, (u64*)y, t, L, logn,
                     (cudaStream_t)stream);
}

// The launch shape K3/K4 use for [L, 2^logn]: out = {cluster blocks,
// threads per block, dynamic shared memory bytes per block, grid blocks,
// K3 clusters resident at once, K4 clusters resident at once}.
extern "C" int ace_ntt_shape(int L, int logn, int* out) {
    if (logn < 1 || logn > LOGN_MAX || L < 1)
        return (int)cudaErrorInvalidValue;
    int lc = 0;
    cudaError_t e = cluster_log(L, logn, &lc);
    if (e != cudaSuccess) return (int)e;
    static cudaError_t (*const k3[])(int, int*) = {
        max_clusters<false, 0>, max_clusters<false, 1>,
        max_clusters<false, 2>, max_clusters<false, 3>,
        max_clusters<false, 4>};
    static cudaError_t (*const k4[])(int, int*) = {
        max_clusters<true, 0>, max_clusters<true, 1>, max_clusters<true, 2>,
        max_clusters<true, 3>, max_clusters<true, 4>};
    out[0] = 1 << lc;
    out[1] = threads_for(logn - lc);
    out[2] = (int)(sizeof(u64) << (logn - lc));
    out[3] = L << lc;
    e = k3[lc](logn, out + 4);
    if (e == cudaSuccess) e = k4[lc](logn, out + 5);
    return (int)e;
}

extern "C" int ace_k3_ntt_fwd(const void* x, void* y, const void* rou,
                              const void* rou_prec, const void* q,
                              const void* rows, int L, int logn,
                              void* stream) {
    LimbArgs t{(const u64*)rou, (const u64*)rou_prec, (const u64*)q,
               nullptr, nullptr, (const long long*)rows};
    return dispatch<false>(x, y, t, L, logn, stream);
}

extern "C" int ace_k4_ntt_inv(const void* x, void* y, const void* rou_inv,
                              const void* rou_inv_prec, const void* q,
                              const void* ninv, const void* ninv_prec,
                              const void* rows, int L, int logn,
                              void* stream) {
    LimbArgs t{(const u64*)rou_inv, (const u64*)rou_inv_prec, (const u64*)q,
               (const u64*)ninv, (const u64*)ninv_prec,
               (const long long*)rows};
    return dispatch<true>(x, y, t, L, logn, stream);
}
