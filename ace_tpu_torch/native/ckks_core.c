/* ckks_core.c — native CPU implementation of the CKKS hot kernels, the
 * host library of ace_tpu_torch (a copy of ace_tpu/native/ckks_core.c;
 * only this comment differs).
 *
 * Role in the port:
 *   1. CPU baseline for bench_torch.py --ntt: single-thread -O3 kernels
 *      equivalent to the reference runtime's hot loops
 *      (rtlib/ant/src/util/ntt.c Forward/Inverse_transform, fhe_utils.h
 *      Shoup/Barrett mults), so the card's NTT rate is divided by a
 *      best-effort CPU implementation on the same host.
 *   2. Host-side golden oracle for tests (exact integer math, canonical
 *      residues — bit-identical to the kernels K1-K4 and their plain
 *      versions).
 * The port's NTT tables are built in numpy (ace_tpu_torch/ops/ntt.py),
 * not through pow_table / shoup_prec here.
 *
 * Own implementation; algorithmic contract per SURVEY.md Appendix A.
 * Built at first use by ace_tpu_torch/ops/native.py:
 *   gcc -O3 -march=native -shared -fPIC -o libckks_core-<hash>.so ckks_core.c
 * into <repo>/build/ace_tpu_torch/.
 */

#include <stdint.h>
#include <stddef.h>

typedef unsigned __int128 u128;

/* Shoup modular multiply: w_prec = floor(w * 2^64 / q). */
static inline uint64_t shoup_mul(uint64_t x, uint64_t w, uint64_t w_prec,
                                 uint64_t q) {
  uint64_t hi = (uint64_t)(((u128)x * w_prec) >> 64);
  uint64_t r = x * w - hi * q;
  return r >= q ? r - q : r;
}

/* Barrett 128-bit reduction with mu = floor(2^128 / q) (two words). */
static inline uint64_t barrett_reduce_128(u128 v, uint64_t q, uint64_t mu_hi,
                                          uint64_t mu_lo) {
  uint64_t v_lo = (uint64_t)v, v_hi = (uint64_t)(v >> 64);
  uint64_t left_h = (uint64_t)(((u128)v_lo * mu_lo) >> 64);
  u128 mid = (u128)v_lo * mu_hi;
  uint64_t tmp1 = (uint64_t)mid + left_h;
  uint64_t carry = tmp1 < left_h;
  uint64_t tmp2 = (uint64_t)(mid >> 64) + carry;
  u128 mid2 = (u128)v_hi * mu_lo;
  carry = ((uint64_t)mid2 + tmp1) < tmp1;
  uint64_t quot = v_hi * mu_hi + tmp2 + (uint64_t)(mid2 >> 64) + carry;
  uint64_t r = v_lo - quot * q;
  while (r >= q) r -= q;
  return r;
}

/* Elementwise modular ops over arrays. */
void ckks_modadd(uint64_t* res, const uint64_t* a, const uint64_t* b,
                 uint64_t q, size_t n) {
  for (size_t i = 0; i < n; i++) {
    uint64_t s = a[i] + b[i];
    res[i] = s >= q ? s - q : s;
  }
}

void ckks_modmul_barrett(uint64_t* res, const uint64_t* a, const uint64_t* b,
                         uint64_t q, uint64_t mu_hi, uint64_t mu_lo,
                         size_t n) {
  for (size_t i = 0; i < n; i++)
    res[i] = barrett_reduce_128((u128)a[i] * b[i], q, mu_hi, mu_lo);
}

/* Forward negacyclic NTT, CT butterflies, natural -> bit-reversed.
 * rou/rou_prec: twiddles in bit-reversed order (rou[brev(i)] = psi^i). */
void ckks_ntt_fwd(uint64_t* d, const uint64_t* rou, const uint64_t* rou_prec,
                  uint64_t q, uint32_t n) {
  for (uint32_t m = 1; m < n; m <<= 1) {
    uint32_t t = n / (2 * m);
    for (uint32_t i = 0; i < m; i++) {
      uint64_t w = rou[m + i], wp = rou_prec[m + i];
      uint64_t* lo = d + i * 2 * t;
      uint64_t* hi = lo + t;
      for (uint32_t j = 0; j < t; j++) {
        uint64_t y = shoup_mul(hi[j], w, wp, q);
        uint64_t x = lo[j];
        uint64_t s = x + y;
        lo[j] = s >= q ? s - q : s;
        hi[j] = x >= y ? x - y : x + q - y;
      }
    }
  }
}

/* Inverse negacyclic NTT, GS butterflies, bit-reversed -> natural,
 * with n^-1 folded into the first (pairwise) stage. */
void ckks_ntt_inv(uint64_t* d, const uint64_t* rou_inv,
                  const uint64_t* rou_inv_prec, uint64_t n_inv,
                  uint64_t n_inv_prec, uint64_t q, uint32_t n) {
  int first = 1;
  for (uint32_t m = n >> 1; m >= 1; m >>= 1) {
    uint32_t t = n / (2 * m);
    for (uint32_t i = 0; i < m; i++) {
      uint64_t w = rou_inv[m + i], wp = rou_inv_prec[m + i];
      uint64_t* lo = d + i * 2 * t;
      uint64_t* hi = lo + t;
      for (uint32_t j = 0; j < t; j++) {
        uint64_t x = lo[j], y = hi[j];
        uint64_t s = x + y;
        s = s >= q ? s - q : s;
        uint64_t df = shoup_mul(x >= y ? x - y : x + q - y, w, wp, q);
        if (first) {
          s = shoup_mul(s, n_inv, n_inv_prec, q);
          df = shoup_mul(df, n_inv, n_inv_prec, q);
        }
        lo[j] = s;
        hi[j] = df;
      }
    }
    first = 0;
  }
}

/* Geometric power table: out[i] = base^i mod q, i in [0, n).
 * Host-side twiddle-table builder for the 4-step NTT (the Python
 * big-int loop is ~100x slower for N=2^16 x 44 limbs). */
void ckks_pow_table(uint64_t base, uint64_t q, uint64_t* out, size_t n) {
  uint64_t acc = 1 % q;
  for (size_t i = 0; i < n; i++) {
    out[i] = acc;
    acc = (uint64_t)(((u128)acc * base) % q);
  }
}

/* Shoup precompute batch: out[i] = floor(w[i] * 2^64 / q). */
void ckks_shoup_prec(const uint64_t* w, uint64_t q, uint64_t* out, size_t n) {
  for (size_t i = 0; i < n; i++) {
    out[i] = (uint64_t)(((u128)w[i] << 64) / q);
  }
}

/* Outer-product power table: out[u*c + b] = base^(u*b) mod q for
 * u in [0, r), b in [0, c) — the 4-step inter-DFT twiddle matrix,
 * with rows emitted in the order given by row_order (bit-reversed u). */
void ckks_twiddle_matrix(uint64_t base, uint64_t q, const uint32_t* row_order,
                         size_t r, size_t c, uint64_t* out) {
  for (size_t u = 0; u < r; u++) {
    /* row u holds powers of base^u */
    uint64_t step = 1 % q;
    uint64_t bu = base;
    size_t e = u;
    while (e) { /* base^u by square-and-multiply */
      if (e & 1) step = (uint64_t)(((u128)step * bu) % q);
      bu = (uint64_t)(((u128)bu * bu) % q);
      e >>= 1;
    }
    uint64_t* row = out + (size_t)row_order[u] * c;
    uint64_t acc = 1 % q;
    for (size_t b = 0; b < c; b++) {
      row[b] = acc;
      acc = (uint64_t)(((u128)acc * step) % q);
    }
  }
}

/* Hybrid key-switch inner MAC for one digit over one limb:
 * acc += key_limb ⊙ raised_limb (mod q). The per-op hot loop of
 * rotations/relinearization (ckks_evaluator.c Fast_switch_key_ext). */
void ckks_mac(uint64_t* acc, const uint64_t* key, const uint64_t* raised,
              uint64_t q, uint64_t mu_hi, uint64_t mu_lo, size_t n) {
  for (size_t i = 0; i < n; i++) {
    uint64_t p = barrett_reduce_128((u128)key[i] * raised[i], q, mu_hi, mu_lo);
    uint64_t s = acc[i] + p;
    acc[i] = s >= q ? s - q : s;
  }
}
