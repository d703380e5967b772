"""Encrypted LLaMA-style attention block — beyond-reference capability.

The reference builds the llama attention graph but never lowers it to
FHE (nn-addon/llama/src/llama_impl.cxx:14-45; the VECTOR pass has no
Matmul/Softmax/Rmsnorm lowering). This module evaluates ONE attention
block under CKKS end-to-end: RMSNorm -> q/k/v projections -> RoPE ->
scores = q k^T/sqrt(d) -> softmax -> probs @ v, using the nonlinear
primitives (rsqrt / exp / Goldschmidt reciprocal, `ckks/nonlinear.py`)
for everything the reference cannot express.

Packing: a single ciphertext holds the activation matrix row-major,
slot[r*d + c] = x[r, c], for seq rows of head_dim d. The layout must be
FULLY PACKED (seq*d == N/2) so global slot rotations wrap row blocks
cyclically; row/column reductions are then log2-depth rotate+add trees
exactly like the conv metakernels.

Scope: n_heads=1, n_rep=1, start_pos=0 (one head of the reference
graph, no kv-cache growth). Multi-head = one ciphertext per head with
identical programs; the kv cache is plaintext-side state management,
orthogonal to the encrypted math.

The same functions as `ace_tpu.models.llama_fhe`, over the port's
evaluator and encoder: the weights are a dict of numpy arrays in both
packages, the mask vectors are built on the host in numpy, and the
ciphertexts and plaintexts live on the evaluator's device.
"""

from __future__ import annotations

import numpy as np

from ace_tpu_torch.ckks import nonlinear as NL


def _mask(ev, enc, ct, values):
    """Multiply by a plaintext mask vector (depth 1)."""
    pt = enc.encode_cached(np.asarray(values, np.complex128),
                           level=ct.level, slots=len(values))
    return ev.rescale(ev.mul_plain(ct, pt))


def _bcast_rows(ev, ct, d: int, total: int):
    """Replicate a single live row block across all rows (input: only
    one row's slots nonzero). log2(seq) rotations."""
    step = d
    while step < total:
        ct = ev.add(ct, ev.rotate(ct, -step))
        step *= 2
    return ct


def _bcast_cols(ev, ct, d: int):
    """Replicate a single live column across its row block (input:
    one live column per row). log2(d) rotations."""
    step = 1
    while step < d:
        ct = ev.add(ct, ev.rotate(ct, -step))
        step *= 2
    return ct


def _matmul_plain_w(ev, enc, ct, w: np.ndarray, seq: int, d: int):
    """Row-wise y_r = W x_r for every row block simultaneously:
    block-diagonal diagonal method, 2d-1 rotations, depth 1
    (the gemm-metakernel idea, tensor2vector_util.cxx:793, restated
    for the row-major [seq, d] packing)."""
    total = seq * d
    acc = None
    for k in range(d):
        # entries read from the same row: columns i with i + k < d
        m1 = np.zeros(total)
        m2 = np.zeros(total)
        for i in range(d):
            j = i + k
            if j < d:
                m1[np.arange(seq) * d + i] = w[i, j]
            else:
                m2[np.arange(seq) * d + i] = w[i, j - d]
        if np.any(m1):
            t = _mask(ev, enc, ev.rotate(ct, k) if k else ct, m1)
            acc = t if acc is None else ev.add(acc, t)
        if np.any(m2):
            t = _mask(ev, enc, ev.rotate(ct, k - d), m2)
            acc = t if acc is None else ev.add(acc, t)
    return acc


def _rope(ev, enc, ct, seq: int, d: int):
    """Rotary embedding: q'[2i] = q[2i] cos - q[2i+1] sin,
    q'[2i+1] = q[2i] sin + q[2i+1] cos, angle per (row=position r,
    pair i): r / 10000^(2i/d). Depth 1, two rotations."""
    total = seq * d
    freqs = 1.0 / (10000.0 ** (2 * np.arange(d // 2) / d))
    ang = np.outer(np.arange(seq), freqs)        # [seq, d/2]
    cos_v = np.zeros(total)
    sin_even = np.zeros(total)                   # coeff of rot(q, +1)
    sin_odd = np.zeros(total)                    # coeff of rot(q, -1)
    for r in range(seq):
        for i in range(d // 2):
            c, s = np.cos(ang[r, i]), np.sin(ang[r, i])
            cos_v[r * d + 2 * i] = c
            cos_v[r * d + 2 * i + 1] = c
            sin_even[r * d + 2 * i] = -s
            sin_odd[r * d + 2 * i + 1] = s
    out = _mask(ev, enc, ct, cos_v)
    out = ev.add(out, _mask(ev, enc, ev.rotate(ct, 1), sin_even))
    out = ev.add(out, _mask(ev, enc, ev.rotate(ct, -1), sin_odd))
    return out


def encrypted_attention(ev, enc, ct_x, weights, seq: int, d: int, *,
                        ms_range=(0.02, 4.0), score_bound=6.0,
                        den_range=None, exp_degree=27):
    """One encrypted attention block on ct_x packed [seq, d] row-major
    (seq*d == N/2). `weights`: dict with rms_weight [d], wq/wk/wv
    [d, d] (same convention as models/llama.build_attention_block:
    projection = x @ W.T). Returns the output ciphertext [seq, d].

    ms_range bounds mean(x^2)+eps for the rsqrt; score_bound bounds
    |q.k/sqrt(d)| for the exp — both are data ranges the caller
    certifies, exactly like the reference's -SIHE:relu_vr value-range
    contract (sihe/src/config.cxx:24-26).

    Packing constraints: seq <= d (score column c of row r lives at
    slot r*d + c, so columns must fit inside a row block) and
    seq * d == N/2 (one ciphertext holds the whole [seq, d] tensor).
    """
    total = seq * d
    if seq > d:
        raise ValueError(
            f"encrypted_attention requires seq <= d (got seq={seq}, "
            f"d={d}): score columns would spill into the next row block")
    if total != ev.params.degree // 2:
        raise ValueError(
            f"encrypted_attention requires seq*d == N/2 "
            f"(got {seq}*{d}={total}, N/2={ev.params.degree // 2})")

    # -- RMSNorm: x * rsqrt(mean(x^2) + eps) * g ------------------------
    sq = ev.rescale(ev.square(ct_x))
    ms = NL.block_sum_replicated(ev, sq, d, total, enc,
                                 mask_scale=1.0 / d)
    ms = ev.add_const(ms, 1e-5)
    r = NL.rsqrt(ev, ms, ms_range[0], ms_range[1], degree=29,
                 newton_iters=2)
    y = ev.rescale(ev.mul(ct_x, r))
    y = _mask(ev, enc, y, np.tile(np.asarray(weights["rms_weight"],
                                             np.float64), seq))

    # -- q/k/v projections (x @ W.T -> rows through W) -------------------
    q = _matmul_plain_w(ev, enc, y, np.asarray(weights["wq"]), seq, d)
    k = _matmul_plain_w(ev, enc, y, np.asarray(weights["wk"]), seq, d)
    v = _matmul_plain_w(ev, enc, y, np.asarray(weights["wv"]), seq, d)

    # -- RoPE on q and k --------------------------------------------------
    q = _rope(ev, enc, q, seq, d)
    k = _rope(ev, enc, k, seq, d)

    # -- scores[r, c] = q_r . k_c / sqrt(d), packed at slot r*d + c ------
    scores = None
    inv_sqrt_d = 1.0 / np.sqrt(d)
    row_c = np.zeros(total)
    for c in range(seq):
        row_c[:] = 0.0
        row_c[c * d:(c + 1) * d] = 1.0
        k_c = _bcast_rows(ev, _mask(ev, enc, k, row_c), d, total)
        prod = ev.rescale(ev.mul(q, k_c))
        ssum = NL.block_sum(ev, prod, d)
        col0 = np.zeros(total)
        col0[np.arange(seq) * d] = inv_sqrt_d
        s_c = _mask(ev, enc, ssum, col0)
        if c:
            s_c = ev.rotate(s_c, -c)
        scores = s_c if scores is None else ev.add(scores, s_c)

    # -- softmax over the first `seq` columns of each row ----------------
    es = NL.exp(ev, scores, -score_bound, score_bound, degree=exp_degree)
    live = np.zeros(total)
    for rr in range(seq):
        live[rr * d:rr * d + seq] = 1.0
    es = _mask(ev, enc, es, live)     # junk columns would add exp(0)=1
    den = NL.block_sum_replicated(ev, es, d, total, enc)
    lo, hi = den_range or (seq * np.exp(-score_bound),
                           seq * np.exp(score_bound))
    if not (0 < lo < hi):
        raise ValueError(f"den_range must satisfy 0 < lo < hi, got "
                         f"({lo}, {hi})")
    # Goldschmidt error <= (1 - lo/hi)^(2^(iters+1)); pick iters for 1e-4
    e0 = 1.0 - lo / hi
    iters = max(1, int(np.ceil(np.log2(np.log(1e-4) / np.log(e0)))) - 1) \
        if e0 > 0 else 1
    if iters > 6:
        raise ValueError(
            f"den_range ({lo:.3g}, {hi:.3g}) needs {iters} Goldschmidt "
            f"iterations (~{2 * iters + 1} levels) — an unusable depth. "
            f"Tighten den_range/score_bound (default bounds at "
            f"score_bound>=2 are far too loose; pass a measured range).")
    inv = NL.reciprocal(ev, den, hi, iters=iters)
    probs = ev.rescale(ev.mul(es, inv))

    # -- out[r, :] = sum_c probs[r, c] * v[c, :] --------------------------
    out = None
    for c in range(seq):
        colc = np.zeros(total)
        colc[np.arange(seq) * d + c] = 1.0
        p_c = _mask(ev, enc, probs, colc)
        if c:
            p_c = ev.rotate(p_c, c)   # move to column 0
        p_c = _bcast_cols(ev, p_c, d)
        row_c = np.zeros(total)
        row_c[c * d:(c + 1) * d] = 1.0
        v_c = _bcast_rows(ev, _mask(ev, enc, v, row_c), d, total)
        t = ev.rescale(ev.mul(p_c, v_c))
        out = t if out is None else ev.add(out, t)
    return out


def attention_plain(x, weights, seq: int, d: int):
    """Plain oracle with identical semantics (n_heads=1, n_rep=1,
    start_pos=0) — cross-checked against models.llama.run_plain."""
    g = np.asarray(weights["rms_weight"], np.float64)
    x = np.asarray(x, np.float64).reshape(seq, d)
    y = x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + 1e-5) * g
    q = y @ np.asarray(weights["wq"], np.float64).T
    k = y @ np.asarray(weights["wk"], np.float64).T
    v = y @ np.asarray(weights["wv"], np.float64).T

    freqs = 1.0 / (10000.0 ** (2 * np.arange(d // 2) / d))
    ang = np.outer(np.arange(seq), freqs)
    cos, sin = np.cos(ang), np.sin(ang)

    def rope(t):
        tr, ti = t[:, 0::2], t[:, 1::2]
        out = np.empty_like(t)
        out[:, 0::2] = tr * cos - ti * sin
        out[:, 1::2] = tr * sin + ti * cos
        return out

    q, k = rope(q), rope(k)
    scores = q @ k.T / np.sqrt(d)
    e = np.exp(scores)
    probs = e / e.sum(axis=-1, keepdims=True)
    return probs @ v
