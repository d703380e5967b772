// Exact modular arithmetic on canonical uint64 residues, shared by the
// kernels of this directory. Same contracts as ops/modops.py (and the
// reference runtime's fhe_utils.h): one conditional correction for
// add/sub/Shoup, two for Barrett-128. Every result is canonical in [0, q).
#pragma once
#include <cstdint>

typedef unsigned long long u64;

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
    u64 s = a + b;
    return s >= q ? s - q : s;
}

__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 q) {
    return a >= b ? a - b : a + q - b;
}

// x*w mod q with wp = floor(w * 2^64 / q); x, w in [0, q).
__device__ __forceinline__ u64 shoup_mul(u64 x, u64 w, u64 wp, u64 q) {
    u64 qq = __umul64hi(x, wp);
    u64 r = x * w - qq * q;
    return r >= q ? r - q : r;
}

// (hi:lo) mod q with mu = floor(2^128 / q) = (mu_hi:mu_lo), the SEAL-style
// word algorithm of Mod_barrett_128 (ops/modops.py barrett_reduce_128).
__device__ __forceinline__ u64 barrett_reduce_128(u64 v_hi, u64 v_lo, u64 q,
                                                  u64 mu_hi, u64 mu_lo) {
    u64 left_h = __umul64hi(v_lo, mu_lo);
    u64 mid_h = __umul64hi(v_lo, mu_hi);
    u64 mid_l = v_lo * mu_hi;
    u64 tmp1 = mid_l + left_h;
    u64 tmp2 = mid_h + (tmp1 < left_h ? 1ull : 0ull);
    u64 mid2_h = __umul64hi(v_hi, mu_lo);
    u64 mid2_l = v_hi * mu_lo;
    u64 left2 = mid2_h + ((mid2_l + tmp1) < tmp1 ? 1ull : 0ull);
    u64 quot = v_hi * mu_hi + tmp2 + left2;
    u64 r = v_lo - quot * q;
    r = r >= q ? r - q : r;
    r = r >= q ? r - q : r;
    return r;
}
