"""Slot-packing lowering: tensors -> 1-D SIMD-slot programs.

The metakernels of `ace_tpu.compiler.packing`, a re-design of the
reference's tensor->vector metakernels
(nn-addon/vector/src/tensor2vector_util.cxx New_conv_metakernel:163,
New_gemm_metakernel_fast:502; vector_utils.cxx Get_im2col_kernel:162).
Capability parity, not a translation:

  - layout: NCHW channel-major flattening into slots, conv computed at
    full resolution via rotation taps against im2col'd diagonal weight
    vectors, strided results masked then compacted
  - conv: acc += rot(dup(x), ci*h*w + ra[k]*stride) * W[ci*khw+k] where
    ra is the kernel-offset table and W rows carry the per-output-
    channel diagonalized weights (so one rotated vector feeds all
    output channels)
  - gemm: BSGS diagonal method (baby rotations x giant steps)
  - stride compaction: log-depth shift-and-mask doubling (own schedule)

Everything here is backend-polymorphic: `be` is a SlotBackend (numpy
plain VM or the CKKS evaluator), so the same lowering executes in the
clear for validation and encrypted for inference.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np


class SlotOverflow(Exception):
    """The packed message does not fit in the ring's slot count; the
    parameter policy catches this to grow poly_degree (the explicit
    analog of onnx2air's slot-requirement contract, air_stmt.h:25-36)."""


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class PlainBackend:
    """Slot VM on numpy vectors (the oracle)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots

    def pack(self, flat: np.ndarray):
        v = np.zeros(self.n_slots)
        v[:len(flat)] = flat
        return v

    def rotate(self, v, k: int):
        return np.roll(v, -k)

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def mul_plain(self, v, w: np.ndarray):
        return v * self.pack(w)

    def add_plain(self, v, w: np.ndarray):
        return v + self.pack(w)

    def rotations_hoisted(self, v, ks):
        return [self.rotate(v, k) for k in ks]

    def relu(self, v, value_range: float = 3.0, mul_depth: int = 13,
             bootstrap: bool = False):
        return np.maximum(v, 0)

    def square(self, v):
        return v * v

    def mul(self, a, b):
        return a * b


class FheBackend:
    """Slot VM on CKKS ciphertexts with inline lazy scale management.

    Mirrors the reference scale manager policy (fhe-cmplr/include/fhe/
    ckks/scale_manager.h:101,442-491): operands are rescaled before a
    multiply when their scale degree exceeds 1.
    """

    def __init__(self, evaluator, encoder, bootstrap_fn=None):
        self.ev = evaluator
        self.enc = encoder
        self.n_slots = evaluator.params.degree // 2
        self.bootstrap_fn = bootstrap_fn
        self._site = None  # [memo, op index, bundles so far]: call_site

    def _norm(self, ct):
        while ct.sf_degree > 1:
            ct = self.ev.rescale(ct)
        return ct

    def pack(self, flat):
        raise NotImplementedError("inputs are ciphertexts")

    def rotate(self, ct, k: int):
        return self.ev.rotate(ct, k)

    def add(self, a, b):
        if a.sf_degree != b.sf_degree:
            a, b = self._norm(a), self._norm(b)
        return self.ev.add(a, b)

    def sub(self, a, b):
        if a.sf_degree != b.sf_degree:
            a, b = self._norm(a), self._norm(b)
        return self.ev.sub(a, b)

    def _encode_like(self, ct, w: np.ndarray):
        vec = np.zeros(self.n_slots, dtype=np.complex128)
        vec[:len(w)] = w
        return self.enc.encode_cached(vec, level=ct.level,
                                      slots=self.n_slots)

    def mul_plain(self, ct, w: np.ndarray):
        ct = self._norm(ct)
        return self.ev.mul_plain(ct, self._encode_like(ct, w))

    def add_plain(self, ct, w: np.ndarray):
        pl = self.enc.encode_cached(
            np.concatenate([w, np.zeros(self.n_slots - len(w))]),
            level=ct.level, slots=self.n_slots, sf_degree=ct.sf_degree)
        return self.ev.add_plain(ct, pl)

    def rotations_hoisted(self, ct, ks):
        return self.ev.rotations_hoisted(ct, ks)

    def mul(self, a, b):
        return self.ev.mul(self._norm(a), self._norm(b))

    def square(self, a):
        a = self._norm(a)
        return self.ev.mul(a, a)

    def relu(self, ct, value_range: float = 3.0, mul_depth: int = 13,
             bootstrap: bool = False):
        """ReLU via bootstrap + composite sign approximation (the SIHE
        pass's Handle_relu lowering, tensor2sihe_impl.h:133-176)."""
        from ace_tpu_torch.ckks import relu as relu_mod
        ct = self._norm(ct)
        if bootstrap:
            if self.bootstrap_fn is None:
                raise RuntimeError("backend has no bootstrap context")
            ct = self.bootstrap_fn(ct)
        return relu_mod.relu(self.ev, ct, value_range, mul_depth)

    # -- hoisted extended-basis accumulation ------------------------------
    # mod-up hoisting (shared digit decompose) + mod-down hoisting
    # (accumulate in the QP basis, one Reduce_rns_base at the end) —
    # the reference's ut_ksw_opt.cxx:349-375 patterns.

    def rot_mac(self, ct, pairs):
        """sum_r rot(ct, r) * w_r with one mod-up and one mod-down."""
        return self.rot_ext_mac_groups(
            ct, [r for r, _ in pairs], [[w for _, w in pairs]])[0]

    @contextlib.contextmanager
    def call_site(self, memo: dict, op_idx: int):
        """Inside, the k-th MAC bundle is the call site (op_idx, k) of
        the graph runner that owns `memo`: its message stack is built at
        the site's first run and kept there (Evaluator.kept_msgs), since
        a compiled graph's weights are fixed. Outside, each bundle
        builds its stack."""
        self._site = [memo, op_idx, 0]
        try:
            yield
        finally:
            self._site = None

    def rot_ext_mac_groups(self, ct, rots, weight_groups):
        """Shared hoisted rotations feeding several weighted MACs:
        returns [sum_k rot(ct, rots[k]) * W[g][k] for each group g],
        with ONE digit decompose/mod-up for all rotations and one
        mod-down per group (the reference's combined mod-up + mod-down
        hoisting, ut_ksw_opt.cxx:349-375), run by the evaluator's
        rot_mac_groups_msgs_jit. Weights ship as level-independent int64
        messages [G, R, N]; the RNS lift + NTT happen inside the bundle.
        Inside a call_site the stack is the site's kept one."""
        ev = self.ev
        ct = self._norm(ct)
        rots = list(rots)
        if self._site is None:
            msgs = self._msg_stack(weight_groups)
        else:
            memo, op_idx, k = self._site
            self._site[2] += 1
            msgs = ev.kept_msgs(memo, (op_idx, k, tuple(rots)),
                                lambda: self._msg_stack(weight_groups))
        return ev.rot_mac_groups_msgs_jit(ct, rots, msgs)

    def _msg_stack(self, weight_groups):
        """[G, R, N] int64 messages of the weight groups, zero rows for
        None or all-zero weights."""
        import torch
        return torch.stack([torch.stack([
            self.enc.encode_msg(self._pad(w), slots=self.n_slots)
            if w is not None and np.any(w) else self.enc.zero_msg()
            for w in W]) for W in weight_groups])

    def rot_sum(self, items):
        """sum_i rot(ct_i, r_i) with a single trailing mod-down per
        chunk of the evaluator's max_bundle rotations."""
        items = [(self._norm(ct), r) for ct, r in items]
        lv = min(ct.level for ct, _ in items)
        return self.ev.rot_sum_jit([(self.ev.at_level(ct, lv), r)
                                    for ct, r in items])

    def _pad(self, w):
        vec = np.zeros(self.n_slots, dtype=np.complex128)
        vec[:len(w)] = w
        return vec


# ---------------------------------------------------------------------------
# Hoisted-accumulation dispatch: FHE backends fold rotation groups into
# extended-basis MACs (one mod-up, one mod-down per group); plain/sim
# backends fall back to per-rotation evaluation.
# ---------------------------------------------------------------------------

def hoisted_mac_groups(be, x, rots, weight_groups):
    """[sum_k rot(x, rots[k]) * W[g][k] for each weight group g]."""
    if hasattr(be, "rot_ext_mac_groups"):
        return be.rot_ext_mac_groups(x, rots, weight_groups)
    rolls = be.rotations_hoisted(x, rots)
    outs = []
    for W in weight_groups:
        acc = None
        for rv, w in zip(rolls, W):
            if w is None or not np.any(w):
                continue
            term = be.mul_plain(rv, w)
            acc = term if acc is None else be.add(acc, term)
        if acc is None:  # all-zero group (e.g. zero conv weights)
            acc = be.mul_plain(x, np.zeros(be.n_slots))
        outs.append(acc)
    return outs


def rot_sum(be, items):
    """sum_i rot(x_i, r_i) (mod-down hoisted on FHE backends)."""
    if hasattr(be, "rot_sum"):
        return be.rot_sum(items)
    acc = None
    for x, r in items:
        v = x if r == 0 else be.rotate(x, r)
        acc = v if acc is None else be.add(acc, v)
    return acc


# ---------------------------------------------------------------------------
# Conv2d lowering
# ---------------------------------------------------------------------------

def conv_ra_offsets(kh: int, kw: int, w: int) -> list[int]:
    """Rotation offsets for kernel taps on a row-major HxW image with
    'same' padding: tap (di, dj) reads position (i+di-p, j+dj-p)."""
    p = (kh - 1) // 2
    return [(di - p) * w + (dj - p)
            for di in range(kh) for dj in range(kw)]


def conv_tap_weights(weight: np.ndarray, h: int, w: int,
                     stride: int = 1) -> tuple[list[int], np.ndarray]:
    """Build rotation taps and per-tap diagonal weight vectors.

    weight: [c_out, c_in, kh, kw]. Returns (rots, W) with W of shape
    [c_in*kh*kw, c_out*h*w]: tap t = (ci, k) contributes
      acc += rot(x_dup, ci*h*w + ra[k]) * W[t]
    where W[t][co*h*w + pos] = weight[co, ci, k] masked by image-border
    validity at pos, and x_dup has the c_in channels replicated so that
    channel reads beyond c_in wrap around.
    """
    c_out, c_in, kh, kw = weight.shape
    ra = conv_ra_offsets(kh, kw, w)
    p = (kh - 1) // 2
    hw = h * w
    # border-validity mask per kernel tap at each output position
    pos_i, pos_j = np.divmod(np.arange(hw), w)
    rots = []
    rows = []
    for ci in range(c_in):
        for k, off in enumerate(ra):
            di, dj = divmod(k, kw)
            src_i = pos_i + (di - p)
            src_j = pos_j + (dj - p)
            valid = ((src_i >= 0) & (src_i < h) &
                     (src_j >= 0) & (src_j < w)).astype(np.float64)
            # diagonal structure: output channel co with tap offset ci
            # reads input channel (co + ci) mod c_in from the replicated
            # input, so the weight row rotates per output channel
            # (cf. Get_im2col_kernel's (i + c1*khw) % (c_in*khw) indexing)
            row = np.zeros(c_out * hw)
            for co in range(c_out):
                row[co * hw:(co + 1) * hw] = (
                    weight[co, (ci + co) % c_in, di, dj] * valid)
            rots.append(ci * hw + off)
            rows.append(row)
    return rots, np.stack(rows)


def dup_input(be, x, length: int, copies: int):
    """x_dup = x ++ x ++ ... (copies), assuming slots beyond are zero."""
    acc = x
    total = 1
    while total < copies:
        shift = total * length
        acc = be.add(acc, be.rotate(acc, -shift))
        total *= 2
    return acc


def conv2d(be, x, weight: np.ndarray, bias: np.ndarray, h: int, w: int,
           stride: int = 1):
    """Encrypted conv2d ('same' padding). x packs [c_in, h, w] NCHW.

    Returns packed [c_out, h/stride, w/stride] (compacted if stride>1).
    Dispatches to the rotation-cheap fast path (khw + c_in rotations)
    when c_out >= c_in, else the plain tap path (c_in*khw rotations) —
    mirroring the reference's Conv_fast policy
    (tensor2vector_handler.h:275-285).

    When c_out*h*w exceeds the ring (channel-expanding stride-2 layers),
    the output channels are split into ring-sized chunks computed as
    independent convs, each stride-compacted, then concatenated with
    negative rotations — this keeps every ResNet layer inside N/2 =
    c_in*h*w slots, one ring size below the reference's packing.
    """
    c_out = weight.shape[0]
    c_in = weight.shape[1]
    hw = h * w
    if c_out * hw > be.n_slots:
        if stride <= 1:
            raise SlotOverflow("full-res output exceeds ring")
        chunk = max(1, be.n_slots // hw)
        ohw = (h // stride) * (w // stride)
        items = []
        for k in range(0, c_out, chunk):
            cs = min(chunk, c_out - k)
            part = conv2d(be, x, weight[k:k + cs], bias[k:k + cs], h, w,
                          stride)
            items.append((part, -(k * ohw)))
        return rot_sum(be, items)
    if c_out >= c_in:
        acc = _conv2d_fast(be, x, weight, h, w)
    else:
        acc = _conv2d_taps(be, x, weight, h, w)
    if stride > 1:
        # No stride premask: compact_strided's gather masks select
        # exactly the stride-valid source slots, so masking first would
        # spend a level to zero slots the gather never reads. Bias is
        # added on the dense compacted layout.
        acc = compact_strided(be, acc, c_out, h, w, stride)
        ohw = (h // stride) * (w // stride)
        acc = be.add_plain(acc, np.repeat(bias, ohw))
    else:
        acc = be.add_plain(acc, np.repeat(bias, hw))
    return acc


def _conv2d_taps(be, x, weight: np.ndarray, h: int, w: int):
    """Plain tap path: one rotation per (ci, k) tap."""
    c_out, c_in, kh, kw = weight.shape
    hw = h * w
    copies = math.ceil((c_out + c_in) / c_in)
    if c_in * hw * max(copies, 2) > be.n_slots:
        raise SlotOverflow("conv_taps input dup exceeds slots")
    xd = dup_input(be, x, c_in * hw, max(copies, 2))
    rots, W = conv_tap_weights(weight, h, w)
    return hoisted_mac_groups(be, xd, rots, [list(W)])[0]


def _conv2d_fast(be, x, weight: np.ndarray, h: int, w: int):
    """Fast path (New_conv_metakernel_fast, tensor2vector_util.cxx:307):

      xd = dup(x, c_out/c_in)                 # c_out*hw slots
      roll_k = rot(xd, ra[k])                 # khw hoisted rotations
      for ci: r_ci = sum_k roll_k * W'[ci,k]  # plaintext MACs
              acc += rot(dup2(r_ci), ci*hw)   # c_in output rotations
      acc *= valid-region mask                # clear dup junk

    where W'[ci,k][m*hw+pos] = weight[(m-ci) mod c_out, m mod c_in, k]
    (the per-output-channel weight rotation of Handle_conv's conv_fast
    block, tensor2vector_handler.h:218-229). c_in is zero-padded until
    it divides c_out (ibid.:172-190).
    """
    c_out, c_in0, kh, kw = weight.shape
    c_in = c_in0
    while c_out % c_in:
        c_in += 1
    if c_in != c_in0:
        wpad = np.zeros((c_out, c_in, kh, kw))
        wpad[:, :c_in0] = weight
        weight = wpad
    hw = h * w
    L = c_out * hw
    dup_num = c_out // c_in
    if L > be.n_slots:
        raise SlotOverflow("conv_fast output exceeds slots")
    xd = dup_input(be, x, c_in * hw, dup_num) if dup_num > 1 else x

    ra = conv_ra_offsets(kh, kw, w)
    p = (kh - 1) // 2
    pos_i, pos_j = np.divmod(np.arange(hw), w)

    # per-ci weight rows over the SAME hoisted kernel-tap rotations
    m_idx = np.arange(c_out)
    groups = []
    for ci in range(c_in):
        rows = []
        for k, off in enumerate(ra):
            di, dj = divmod(k, kw)
            src_i = pos_i + (di - p)
            src_j = pos_j + (dj - p)
            valid = ((src_i >= 0) & (src_i < h) &
                     (src_j >= 0) & (src_j < w)).astype(np.float64)
            wvals = weight[(m_idx - ci) % c_out, m_idx % c_in, di, dj]
            rows.append((wvals[:, None] * valid[None, :]).reshape(-1))
        groups.append(rows)
    r_cis = hoisted_mac_groups(be, xd, ra, groups)

    items = [(r_cis[0], 0)]
    for ci in range(1, c_in):
        r_ci = r_cis[ci]
        if 2 * L <= be.n_slots:
            r_dup = be.add(r_ci, be.rotate(r_ci, -L))
        else:
            if L != be.n_slots:
                raise SlotOverflow("conv_fast dup exceeds slots")
            r_dup = r_ci  # full ring: rotation wraps naturally
        items.append((r_dup, ci * hw))
    acc = rot_sum(be, items)
    # clear junk beyond the c_out*hw valid region left by the dup2 copies
    if c_in > 1 and 2 * L <= be.n_slots and L < be.n_slots:
        mask = np.ones(L)
        acc = be.mul_plain(acc, mask)
    return acc


def stride_mask(h: int, w: int, stride: int) -> np.ndarray:
    m = np.zeros((h, w))
    m[::stride, ::stride] = 1.0
    return m.reshape(-1)


def gather_by_delta(be, x, pairs):
    """Slot gather out[dst] = x[src] for (src, dst) pairs, src >= dst.

    Groups pairs by shift delta: one hoisted rotation per distinct
    delta plus a target-select mask — each output slot is written by
    exactly one term, so the schedule is collision-free by
    construction. Non-selected slots are zero.
    """
    n = be.n_slots
    groups: dict[int, list[int]] = {}
    for src, dst in pairs:
        groups.setdefault(src - dst, []).append(dst)
    deltas = sorted(groups)
    if deltas == [0]:
        mask = np.zeros(n)
        mask[groups[0]] = 1.0
        return be.mul_plain(x, mask)
    masks = []
    for d in deltas:
        mask = np.zeros(n)
        mask[groups[d]] = 1.0
        masks.append(mask)
    return hoisted_mac_groups(be, x, deltas, [masks])[0]


def compact_strided(be, x, c: int, h: int, w: int, stride: int):
    """Compact stride-masked [c, h, w] (valid at multiples of stride)
    into dense [c, h/s, w/s].

    Three gather levels, one hoisted rotation per distinct shift:
      1. columns  j*s -> j inside every strided row       (ow deltas)
      2. rows     i*s*w -> i*ow, fused row-select + row-tighten: the
         shift i*(s*w - ow) is column-independent, so the former
         separate rows and rows-tight passes collapse into one (saves
         a whole mul level on every downsample segment)
      3. channels ch*hw -> ch*oh*ow                       (c deltas)
    Same capability as the reference's Combine_cross_row/rc/channel
    (tensor2vector_util.cxx:1112-1164), own (shallower) schedule.
    """
    s = stride
    oh, ow = h // s, w // s
    hw = h * w
    # pass 1: cols j*s -> j within every strided row of every channel
    pairs = [(ch * hw + r * w + j * s, ch * hw + r * w + j)
             for ch in range(c) for r in range(0, h, s) for j in range(ow)]
    x = gather_by_delta(be, x, pairs)
    # pass 2: rows i*s (width w) -> tight rows i*ow in one shift:
    # delta = i*(s*w - ow) for every column j < ow
    pairs = [(ch * hw + i * s * w + j, ch * hw + i * ow + j)
             for ch in range(c) for i in range(oh) for j in range(ow)]
    x = gather_by_delta(be, x, pairs)
    # pass 3: channels tight (block ch*hw -> ch*oh*ow)
    blk = oh * ow
    pairs = [(ch * hw + t, ch * blk + t)
             for ch in range(c) for t in range(blk)]
    return gather_by_delta(be, x, pairs)


# ---------------------------------------------------------------------------
# GEMM (BSGS diagonal method) and pooling
# ---------------------------------------------------------------------------

def gemm_diagonals(weight: np.ndarray) -> np.ndarray:
    """Extended diagonals of weight [rows, cols] with rows | cols:
    diag[d][i] = W[i mod rows, (i+d) mod cols], so that
      z[i] = sum_{d<rows} diag[d][i] * x[(i+d) mod cols]
    and folding z by rot multiples of `rows` yields y in slots [0, rows).
    """
    rows, cols = weight.shape
    i = np.arange(cols)
    return np.stack([weight[i % rows, (i + d) % cols]
                     for d in range(rows)])


def gemm(be, x, weight: np.ndarray, bias: np.ndarray):
    """y = W x + b via the BSGS extended-diagonal method
    (capability parity with New_gemm_metakernel_fast,
    tensor2vector_util.cxx:502; own formulation).

    weight: [out_dim, in_dim], out_dim | in_dim (caller zero-pads).
    x packs in_dim values. Result: slots [0, out_dim) hold y (higher
    slots contain fold residue; mask downstream if needed).
    """
    out_dim, in_dim = weight.shape
    rows = out_dim
    assert in_dim % rows == 0
    xd = dup_input(be, x, in_dim, 2)
    diags = gemm_diagonals(weight)
    h1 = 2 ** int(math.ceil(math.log2(max(rows, 1)) / 2))
    h2 = math.ceil(rows / h1)
    # per-giant-step diagonal rows over the shared baby rotations;
    # diag d is shifted right by b2*h1 in full slot space so the giant
    # rotation of the inner sum aligns every term at once
    groups = []
    for b2 in range(h2):
        rows_b2 = []
        for b1 in range(h1):
            d = b2 * h1 + b1
            rows_b2.append(
                np.concatenate([np.zeros(b2 * h1), diags[d]])
                if d < rows else None)
        groups.append(rows_b2)
    inners = hoisted_mac_groups(be, xd, list(range(h1)), groups)
    acc = rot_sum(be, [(inner, b2 * h1)
                       for b2, inner in enumerate(inners)
                       if inner is not None])
    # fold the cols/rows windows down onto slots [0, rows)
    span = in_dim
    while span > rows:
        span //= 2
        acc = be.add(acc, be.rotate(acc, span))
    return be.add_plain(acc, bias)


def average_pool(be, x, c: int, h: int, w: int, k: int):
    """k x k average pooling with stride k (NCHW packed)."""
    # avg-pool taps read (i*k+di, j*k+dj), anchored top-left (no padding)
    hw = h * w
    m2 = np.zeros((h, w))
    m2[::k, ::k] = 1.0 / (k * k)
    mask = np.tile(m2.reshape(-1), c)
    taps = [di * w + dj for di in range(k) for dj in range(k)]
    acc = hoisted_mac_groups(be, x, taps, [[mask] * len(taps)])[0]
    return compact_strided(be, acc, c, h, w, k)


def global_average_pool(be, x, c: int, h: int, w: int):
    """Mean over each channel's h*w block -> c values at stride h*w,
    then compacted to the first c slots."""
    hw = h * w
    acc = x
    step = 1
    while step < hw:
        acc = be.add(acc, be.rotate(acc, step))
        step *= 2
    mask = np.zeros(c * hw)
    mask[::hw] = 1.0 / hw
    acc = be.mul_plain(acc, mask)
    # compact c values at stride hw into the first c slots
    return gather_by_delta(be, acc, [(ch * hw, ch) for ch in range(c)])
