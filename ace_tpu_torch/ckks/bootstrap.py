"""CKKS bootstrapping: mod-raise, CoeffsToSlots, approximate mod
reduction (Chebyshev sine + double-angle), SlotsToCoeffs.

The bootstrap of `ace_tpu.ckks.bootstrap`, replicating the reference
pipeline (fhe-cmplr/rtlib/ant/src/util/ckks_bootstrap_context.c
Eval_bootstrap :1584-1862) with the FFT-factored homomorphic
encoding/decoding (Coeff_enc/dec_one_level :419-513, Select_layers :513,
Coeff_collapse :612-778) at the level budget LEVEL_BUDGET.

The host tables (sine coefficients, FFT parameters, collapsed diagonal
matrices) are numpy float64 computed exactly as in ace_tpu, line for
line: the diagonals must agree float for float, or an llround step of an
encoded diagonal moves and the residues stop matching.

The per-level transforms (fully-packed AND sparse) use the reference's
BSGS + extended-basis accumulation (Rotate_iteration :1237-1383,
Evaluator.bsgs_iter_jit): baby-step hoisted rotations, giant-step
rotations over mod-down-hoisted partials, b+g key-switches per level.
fft_params gives every level at least two baby steps (g >= 2).

Sine approximation constants are the reference's tables
(ckks_bootstrap_context.h:60-101 hw<=192: K=32, R=3, 55 coeffs;
:132-173 uniform: K=512, R=6, 89 coeffs).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ace_tpu_torch.ckks.cheby import ChebyEvaluator
from ace_tpu_torch.ckks.cipher import Ciphertext
from ace_tpu_torch.poly import poly as P
from ace_tpu_torch.poly.poly import RnsPoly
from ace_tpu_torch.runtime.timing import TIMING

# (CoeffsToSlots, SlotsToCoeffs) levels: Bootstrap_precom's fixed budget
# (rtlib/context.c:162-167)
LEVEL_BUDGET = (3, 3)
# ckks_bootstrap_context.h:70-101 (G_coefficients_uniform_hw_192)
K_UNIFORM_HW_192 = 32
R_UNIFORM_HW_192 = 3
SINE_COEFFS_HW_192 = [
    1.74551960283504837e-01, -3.43838095837535329e-02,
    1.88307649106864788e-01, -2.84223873992535993e-02,
    2.22419882865789564e-01, -1.43397005803286518e-02,
    2.51103798550390944e-01, 9.50854609032555226e-03,
    2.24475678532524398e-01, 3.79342483118012136e-02,
    8.78908877085935597e-02, 5.18464470537667449e-02,
    -1.40269389175310705e-01, 2.52026526332414826e-02,
    -2.71343812500084935e-01, -3.49285487170959558e-02,
    -6.17395308539803664e-02, -5.05648932050318592e-02,
    2.82155868186952818e-01, 2.98272328751879069e-02,
    5.54332147538673034e-02, 4.73762170911353267e-02,
    -3.42589653109854397e-01, -7.19260908452365733e-02,
    3.19234546310780576e-01, 4.93494016031356467e-02,
    -1.74337152324168188e-01, -2.23994935740034137e-02,
    6.76154588798445894e-02, 7.56838175610476029e-03,
    -2.01915893273537893e-02, -2.01996389480041394e-03,
    4.85990579019698801e-03, 4.41705640530539389e-04,
    -9.71526466295980677e-04, -8.11544278739113802e-05,
    1.64814371135792263e-04, 1.27637159472312703e-05,
    -2.41183607585707303e-05, -1.74347427937465971e-06,
    3.08411936249047440e-06, 2.09259735883450997e-07,
    -3.48280526734833634e-07, -2.22825972864890841e-08,
    3.50404774489712212e-08, 2.12216680463557985e-09,
    -3.16453692971713038e-09, -1.82031853692548044e-10,
    2.58203419199988530e-10, 1.41483617957390541e-11,
    -1.91412743082734574e-11, -1.00089939783634691e-12,
    1.29702147256041809e-12, 6.67556346626149772e-14,
    -7.81869621069283006e-14,
]

# ckks_bootstrap_context.h:132-173 (G_coefficients_uniform), hw > 192
K_UNIFORM = 512
R_UNIFORM = 6
SINE_COEFFS_UNIFORM = [
    0.15421426400235561, -0.0037671538417132409, 0.16032011744533031,
    -0.0034539657223742453, 0.17711481926851286, -0.0027619720033372291,
    0.19949802549604084, -0.0015928034845171929, 0.21756948616367638,
    0.00010729951647566607, 0.21600427371240055, 0.0022171399198851363,
    0.17647500259573556, 0.0042856217194480991, 0.086174491919472254,
    0.0054640252312780444, -0.046667988130649173, 0.0047346914623733714,
    -0.17712686172280406, 0.0016205080004247200, -0.22703114241338604,
    -0.0028145845916205865, -0.13123089730288540, -0.0056345646688793190,
    0.078818395388692147, -0.0037868875028868542, 0.23226434602675575,
    0.0021116338645426574, 0.13985510526186795, 0.0059365649669377071,
    -0.13918475289368595, 0.0018580676740836374, -0.23254376365752788,
    -0.0054103844866927788, 0.056840618403875359, -0.0035227192748552472,
    0.25667909012207590, 0.0055029673963982112, -0.073334392714092062,
    0.0027810273357488265, -0.24912792167850559, -0.0069524866497120566,
    0.21288810409948347, 0.0017810057298691725, 0.088760951809475269,
    0.0055957188940032095, -0.31937177676259115, -0.0087539416335935556,
    0.34748800245527145, 0.0075378299617709235, -0.25116537379803394,
    -0.0047285674679876204, 0.13970502851683486, 0.0023672533925155220,
    -0.063649401080083698, -0.00098993213448982727, 0.024597838934816905,
    0.00035553235917057483, -0.0082485030307578155, -0.00011176184313622549,
    0.0024390574829093264, 0.000031180384864488629, -0.00064373524734389861,
    -7.8036008952377965e-6, 0.00015310015145922058, 1.7670804180220134e-6,
    -0.000033066844379476900, -3.6460909134279425e-7, 6.5276969021754105e-6,
    6.8957843666189918e-8, -1.1842811187642386e-6, -1.2015133285307312e-8,
    1.9839339947648331e-7, 1.9372045971100854e-9, -3.0815418032523593e-8,
    -2.9013806338735810e-10, 4.4540904298173700e-9, 4.0505136697916078e-11,
    -6.0104912807134771e-10, -5.2873323696828491e-12, 7.5943206779351725e-11,
    6.4679566322060472e-13, -9.0081200925539902e-12, -7.4396949275292252e-14,
    1.0057423059167244e-12, 8.1701187638005194e-15, -1.0611736208855373e-13,
    -8.9597492970451533e-16, 1.1421575296031385e-14,
]


def reduce_rotation(idx: int, slots: int) -> int:
    return idx % slots


def select_layers(log_slots: int, budget: int):
    """Select_layers (ckks_bootstrap_context.c:513-550)."""
    layers = math.ceil(log_slots / budget)
    rows = log_slots // layers
    rem = log_slots % layers
    dim = rows + (1 if rem else 0)
    if dim < budget:
        layers -= 1
        rows = log_slots // layers
        rem = log_slots - rows * layers
        dim = rows + (1 if rem else 0)
        while dim != budget:
            rows -= 1
            rem = log_slots - rows * layers
            dim = rows + (1 if rem else 0)
    return layers, rows, rem


def fft_params(slots: int, level_budget: int):
    """Get_colls_fft_params (:551-610). Returns a dict of the
    CKKS_BOOT_PARAMS fields."""
    log_slots = int(math.log2(slots))
    layers_coll, _, rem_coll = select_layers(log_slots, level_budget)
    flag_rem = 1 if rem_coll else 0
    num_rot = (1 << (layers_coll + 1)) - 1
    num_rot_rem = (1 << (rem_coll + 1)) - 1
    g = 1 << (layers_coll // 2 + (2 if num_rot > 7 else 1))
    b = (num_rot + 1) // g
    b_rem = g_rem = 0
    if flag_rem:
        g_rem = 1 << (rem_coll // 2 + (2 if num_rot_rem > 7 else 1))
        b_rem = (num_rot_rem + 1) // g_rem
    return dict(level_budget=level_budget, layers_coll=layers_coll,
                rem_coll=rem_coll, num_rot=num_rot, b=b, g=g,
                num_rot_rem=num_rot_rem, b_rem=b_rem, g_rem=g_rem,
                flag_rem=flag_rem)


def _coeff_one_level(ksipows, rot_group, encoding: bool, flag: bool):
    """Coeff_enc_one_level / Coeff_dec_one_level (:419-513)."""
    dim = len(ksipows) - 1
    slots = len(rot_group)
    log_slots = int(math.log2(slots))
    coeff = np.zeros((3 * log_slots, slots), dtype=np.complex128)
    m = slots
    while m > 1:
        s = int(math.log2(m)) - 1
        lenh = m >> 1
        lenq = m << 2
        for k in range(0, slots, m):
            for j in range(lenh):
                if encoding:
                    jt = (lenq - rot_group[j] % lenq) * (dim // lenq)
                else:
                    jt = (rot_group[j] % lenq) * (dim // lenq)
                if flag and m == 2:
                    # cexp(±M_PI/2*I) as cos+i*sin (glibc sincos), not
                    # np.exp — ULP parity with the reference tables
                    half_pi = (-1.0 if encoding else 1.0) * np.pi / 2
                    val = complex(np.cos(half_pi), np.sin(half_pi))
                    w = val * ksipows[jt]
                else:
                    val = 1.0
                    w = ksipows[jt]
                if encoding:
                    coeff[s + log_slots][j + k] = val
                    coeff[s + 2 * log_slots][j + k] = val
                    coeff[s + log_slots][j + k + lenh] = -w
                    coeff[s][j + k + lenh] = w
                else:
                    coeff[s + log_slots][j + k] = val
                    coeff[s + 2 * log_slots][j + k] = w
                    coeff[s + log_slots][j + k + lenh] = -w
                    coeff[s][j + k + lenh] = val
        m >>= 1
    return coeff


def coeff_collapse(ksipows, rot_group, level_budget: int, flag: bool,
                   encoding: bool):
    """Coeff_collapse (:612-778): collapse log_slots FFT layers into
    level_budget banded matrices of extended diagonals."""
    slots = len(rot_group)
    log_slots = int(math.log2(slots))
    layers_coll, _, rem_coll = select_layers(log_slots, level_budget)
    flag_rem = 1 if rem_coll else 0
    num_rot = (1 << (layers_coll + 1)) - 1
    num_rot_rem = (1 << (rem_coll + 1)) - 1
    coeff1 = _coeff_one_level(ksipows, rot_group, encoding, flag)

    coeff = []
    for idx in range(level_budget):
        if flag_rem and ((encoding and idx < 1)
                         or (not encoding and idx >= level_budget - 1)):
            coeff.append(np.zeros((num_rot_rem, slots), np.complex128))
        else:
            coeff.append(np.zeros((num_rot, slots), np.complex128))

    for s in range(level_budget):
        if encoding:
            top = log_slots - (level_budget - 1 - s) * layers_coll - 1
        else:
            top = s * layers_coll
        is_rem = flag_rem and ((encoding and s == 0)
                               or (not encoding and s == level_budget - 1))
        end_l = rem_coll if is_rem else layers_coll
        for l in range(end_l):
            if l == 0:
                coeff[s][0] = coeff1[top]
                coeff[s][1] = coeff1[top + log_slots]
                coeff[s][2] = coeff1[top + 2 * log_slots]
            else:
                temp = np.zeros_like(coeff[s])
                if encoding:
                    t = 0
                    for u in range((1 << (l + 1)) - 1):
                        tu = coeff[s][u].copy()
                        k = np.arange(slots)
                        ridx = (k - (1 << (top - l))) % slots
                        ridx2 = (k + (1 << (top - l))) % slots
                        temp[u + t] += coeff1[top - l] * tu[ridx]
                        temp[u + t + 1] += \
                            coeff1[top - l + log_slots] * tu
                        temp[u + t + 2] += \
                            coeff1[top - l + 2 * log_slots] * tu[ridx2]
                        t += 1
                else:
                    for t in range(3):
                        for u in range((1 << (l + 1)) - 1):
                            tu = coeff[s][u].copy()
                            if t == 0:
                                temp[u] += coeff1[top + l] * tu
                            elif t == 1:
                                temp[u + (1 << l)] += \
                                    coeff1[top + l + log_slots] * tu
                            else:
                                temp[u + (1 << (l + 1))] += \
                                    coeff1[top + l + 2 * log_slots] * tu
                coeff[s] = temp
    return coeff


def bootstrap_rotation_indices(degree: int, slots: int = 0) -> list:
    """Rotation indices a bootstrap at this slot count will use
    (Bootstrap_keygen's inventory, ckks_bootstrap_context.c:1194) —
    host-only math, for key planning / the compile manifest."""
    n = degree
    slots = slots or n // 2
    log_slots = int(math.log2(slots))
    full_pack = slots == n // 2
    out = set()
    for encoding, budget in ((True, min(LEVEL_BUDGET[0], log_slots) or 1),
                             (False, min(LEVEL_BUDGET[1], log_slots) or 1)):
        p = fft_params(slots, budget)
        slots_value = ((2 * slots if not full_pack else slots)
                       if encoding else (n // 2))
        flag_rem = p["flag_rem"]
        start = flag_rem if encoding else 0
        end = budget if encoding else budget - flag_rem
        steps = [(s, False) for s in range(start, end)]
        if flag_rem:
            steps.append((0 if encoding else budget - 1, True))
        for s, is_rem in steps:
            nr = p["num_rot_rem"] if is_rem else p["num_rot"]
            g = p["g_rem"] if is_rem else p["g"]
            if encoding:
                shift = 1 if is_rem else \
                    (1 << ((s - flag_rem) * p["layers_coll"]
                           + p["rem_coll"]))
            else:
                shift = 1 << (s * p["layers_coll"])
            h = (nr + 1) // 2 - 1
            if g > 1 and nr > g:
                for j in range(g):
                    out.add(reduce_rotation(j * shift, slots_value))
                for i in range(-(-nr // g)):
                    out.add(reduce_rotation((i * g - h) * shift,
                                            slots_value))
            else:
                for u in range(nr):
                    out.add(reduce_rotation((u - h) * shift, slots_value))
    if not full_pack:
        step = slots
        while step < n // 2:
            out.add(step)
            step *= 2
        out.add(slots)
    out.discard(0)
    return sorted(out)


class BootstrapContext:
    """Per-slot-count bootstrap precompute bound to an Evaluator."""

    def __init__(self, ev, slots: int = 0):
        self.ev = ev
        params = ev.params
        n = params.degree
        m = 2 * n
        self.slots = slots or n // 2
        slots = self.slots
        self.is_sparse = (4 * slots != m)
        log_slots = int(math.log2(slots))
        budget_enc = min(LEVEL_BUDGET[0], log_slots) if log_slots else 1
        budget_dec = min(LEVEL_BUDGET[1], log_slots) if log_slots else 1
        self.enc_params = fft_params(slots, budget_enc)
        self.dec_params = fft_params(slots, budget_dec)

        slots4 = 4 * slots
        rot_group = np.empty(slots, dtype=np.int64)
        five = 1
        for i in range(slots):
            rot_group[i] = five
            five = (five * 5) % slots4
        # cos + i*sin exactly as the reference (:1117-1122) — np.exp's
        # complex path rounds differently at the ULP, which would make
        # every encoded diagonal differ by one llround step from the
        # reference-binary vectors
        ang = 2.0 * np.pi * np.arange(slots4 + 1) / slots4
        ksipows = np.cos(ang) + 1j * np.sin(ang)
        ksipows[slots4] = ksipows[0]

        q0 = params.crt.q_primes[0]
        factor = 2.0 ** round(math.log2(q0))
        pre = q0 / factor
        k_scale = 1.0
        self.scale_enc = pre / k_scale
        self.scale_dec = 1.0 / pre
        self.q0 = q0
        self.deg = round(math.log2(q0 / params.scaling_factor))

        hw = params.hamming_weight
        if 0 < hw <= 192:
            self.sine_coeffs = SINE_COEFFS_HW_192
            self.double_angle = R_UNIFORM_HW_192
            self.k_bound = K_UNIFORM_HW_192
        else:
            self.sine_coeffs = SINE_COEFFS_UNIFORM
            self.double_angle = R_UNIFORM
            self.k_bound = K_UNIFORM

        def collapse(budget: int, encoding: bool):
            c1 = coeff_collapse(ksipows, rot_group, budget, False, encoding)
            if not self.is_sparse:
                return c1
            # sparse packing: the conjugate-channel tables (flag=True)
            # are CONCATENATED onto the primary ones, giving 2*slots
            # diagonals — this is how the imaginary/conjugate halves of
            # the coefficient vector survive the sparse path
            # (Coeffs2slots_precomp/Slots2coeffs_precomp merge,
            # ckks_bootstrap_context.c:795-825, 884-913)
            c2 = coeff_collapse(ksipows, rot_group, budget, True, encoding)
            return [np.concatenate([a, b], axis=1) for a, b in zip(c1, c2)]

        self.enc_coeff = collapse(budget_enc, True)
        self.dec_coeff = collapse(budget_dec, False)
        # pre-normalize the encoding matrices by 1/(N * K * 2^deg),
        # distributed per level (ckks_bootstrap_context.c:828-858)
        factor = 1.0 / n / self.k_bound / (2.0 ** self.deg)
        factor = factor ** (1.0 / budget_enc)
        self.enc_coeff = [c * factor for c in self.enc_coeff]
        # each BSGS level's message stack by (encoding, s, is_rem): the
        # tables above, the scales and the shifts fix it (_transform)
        self._msg_stacks: dict = {}

    # -- homomorphic encoding/decoding ----------------------------------

    def _transform(self, ct: Ciphertext, encoding: bool) -> Ciphertext:
        """Coeff_slots_transform (:1383-1494): one BSGS level per
        collapsed FFT level, a rescale between levels."""
        ev = self.ev
        p = self.enc_params if encoding else self.dec_params
        coeff = self.enc_coeff if encoding else self.dec_coeff
        slots = self.slots
        n4 = self.ev.params.degree // 2
        # rotation-offset reduction period: intermediates are
        # 2*slots-periodic in the sparse case (merged conjugate-channel
        # diagonals), so offsets must not be folded mod slots
        slots_value = ((2 * slots if self.is_sparse else slots)
                       if encoding else n4)
        flag_rem = p["flag_rem"]
        budget = p["level_budget"]
        start = flag_rem if encoding else 0
        end = budget if encoding else budget - flag_rem
        order = list(range(end - 1, start - 1, -1)) if encoding \
            else list(range(start, end))
        rem_steps = [0] if (flag_rem and encoding) else \
            ([budget - 1] if flag_rem else [])
        steps = [(s, False) for s in order] + [(s, True) for s in rem_steps]

        first = True
        for s, is_rem in steps:
            if not first:
                ct = ev.rescale(ct)
            first = False
            nr = p["num_rot_rem"] if is_rem else p["num_rot"]
            if encoding:
                shift = 1 if is_rem else \
                    (1 << ((s - flag_rem) * p["layers_coll"] + p["rem_coll"]))
            else:
                shift = 1 << (s * p["layers_coll"])
            offs = [reduce_rotation((u - (nr + 1) // 2 + 1) * shift,
                                    slots_value) for u in range(nr)]
            # apply diag scale at the designated level
            apply_scale = is_rem if flag_rem else (
                s == (start if encoding else end - 1))
            scale = (self.scale_enc if encoding else self.scale_dec) \
                if apply_scale else 1.0
            g = p["g_rem"] if is_rem else p["g"]
            msgs = ev.kept_msgs(
                self._msg_stacks, (encoding, s, is_rem),
                lambda: self._level_msgs(
                    [coeff[s][u] * scale for u in range(nr)], shift, g))
            ct = self._bsgs_level(ct, offs, msgs, shift, g)
        return ct

    def _level_msgs(self, diags, shift: int, g: int) -> torch.Tensor:
        """The [b, g, N] messages of one BSGS level: giant step i's
        diagonals pre-rolled by g*i*shift, zero rows past the last.

        Reference grouping (Rotate_iteration :1237-1383): the BABY
        rotations are the centered offsets offs[0:g]; giant step i
        rotates by +g*i*shift with its diagonals pre-rolled the opposite
        way (Rotate_precomp :354-366 Rotate_vector by
        Reduce_rotation(-g*i*shift, m/4)). Zero diagonals are encoded,
        not skipped — the reference encodes every dim2 != num_rot, and
        encode(0) is not the zero polynomial (llround's +0.5 bias), so
        skipping would break bit-exactness vs the reference-binary stage
        vectors. In the sparse case the diagonals are the merged 2*slots
        conjugate-channel tables, and the roll period is their length."""
        enc = self.ev.encoder
        nr = len(diags)
        rows = []
        for i in range(-(-nr // g)):
            for j in range(g):
                u = i * g + j
                if u >= nr:
                    rows.append(enc.zero_msg())
                    continue
                d = np.roll(diags[u], (g * i * shift) % len(diags[u]))
                rows.append(enc.encode_msg(d, slots=len(d)))
        return torch.stack(rows).view(-1, g, rows[0].numel())

    def _bsgs_level(self, ct: Ciphertext, offs, msgs: torch.Tensor,
                    shift: int, g: int) -> Ciphertext:
        """One collapsed FFT level as baby-step/giant-step rotations
        (Rotate_iteration, ckks_bootstrap_context.c:1284-1365): baby
        rotations offs[:g] feed per-giant-step MAC groups over the
        level's messages (_level_msgs), giant step i rotating by
        g*i*shift (Evaluator.bsgs_iter_jit). In the sparse case the
        offsets were reduced mod the merged 2*slots period (_transform).
        """
        assert g >= 2, f"fft_params gives g >= 2, got {g}"
        ev = self.ev
        m4 = ev.params.degree // 2
        b = -(-len(offs) // g)
        giants = [reduce_rotation(g * i * shift, m4) for i in range(b)]
        return ev.bsgs_iter_jit(ct, list(offs[:g]), giants, msgs)

    def coeffs_to_slots(self, ct: Ciphertext) -> Ciphertext:
        with TIMING.tm("RTM_BS_COEFF_TO_SLOT"):
            return self._transform(ct, True)

    def slots_to_coeffs(self, ct: Ciphertext) -> Ciphertext:
        with TIMING.tm("RTM_BS_SLOT_TO_COEFF"):
            return self._transform(ct, False)

    # -- approximate mod reduction --------------------------------------

    def eval_approx_mod(self, ct: Ciphertext) -> Ciphertext:
        """Chebyshev sine + double-angle (:1512-1582)."""
        ev = self.ev
        with TIMING.tm("RTM_BS_APPROX_MOD"):
            out = ChebyEvaluator(ev).eval_chebyshev(ct, self.sine_coeffs,
                                                    -1.0, 1.0)
            for j in range(1, self.double_angle + 1):
                sq = ev.mul(out, out)
                out = ev.add_const(
                    ev.rescale(ev.add(sq, sq)),
                    -1.0 / (2.0 * np.pi) ** (2.0 ** (j - self.double_angle)))
        return out

    # -- main flow -------------------------------------------------------

    def bootstrap(self, ct: Ciphertext) -> Ciphertext:
        """Eval_bootstrap (:1584-1862), fully-packed and sparse paths."""
        ev = self.ev
        crt = ev.params.crt
        n = ev.params.degree
        m = 2 * n

        with TIMING.tm("RTM_BS_MOD_RAISE"):
            while ct.sf_degree > 1:
                ct = ev.rescale(ct)
            # use only the last tower: drop to level 1, to coeff form
            k = crt.q_rows(1)
            c0 = RnsPoly(ct.c0.data[:k], 1, 0, ct.c0.is_ntt)
            c1 = RnsPoly(ct.c1.data[:k], 1, 0, ct.c1.is_ntt)
            if c0.is_ntt:
                c0 = P.from_ntt(c0, crt)
                c1 = P.from_ntt(c1, crt)
            c0 = P.to_ntt(P.mod_raise(c0, crt, crt.num_q), crt)
            c1 = P.to_ntt(P.mod_raise(c1, crt, crt.num_q), crt)
            raised = Ciphertext(c0, c1, ct.scaling_factor, 1, ct.slots)

        if self.is_sparse:
            # partial sums fold the sparse repeats (:1746-1756)
            with TIMING.tm("RTM_BS_PARTIAL_SUM"):
                step = self.slots
                while step < n // 2:
                    raised = ev.add(raised, ev.rotate(raised, step))
                    step *= 2

        enc = self.coeffs_to_slots(raised)

        if not self.is_sparse:
            conj = ev.conjugate(enc)
            sub = ev.sub(enc, conj)
            enc = ev.add(enc, conj)
            sub = ev.mul_by_monomial(sub, 3 * m // 4)
            while enc.sf_degree > 1:
                enc = ev.rescale(enc)
                sub = ev.rescale(sub)
            enc = self.eval_approx_mod(enc)
            sub = self.eval_approx_mod(sub)
            sub = ev.mul_by_monomial(sub, m // 4)
            enc = ev.add(enc, sub)
        else:
            conj = ev.conjugate(enc)
            enc = ev.add(enc, conj)
            while enc.sf_degree > 1:
                enc = ev.rescale(enc)
            enc = self.eval_approx_mod(enc)

        res = self.slots_to_coeffs(enc)
        if self.is_sparse:
            res = ev.add(res, ev.rotate(res, self.slots))

        # clear imaginary part + restore q0/sf scaling (:1812-1831)
        if self.deg >= 1:
            conj = ev.conjugate(res)
            res = ev.add(res, conj)
            ratio = int(2.0 ** (self.deg - 1))
            if ratio > 1:
                res = ev.mul_integer(res, ratio)
        else:
            res = ev.mul_integer(res, int(2.0 ** self.deg))

        while res.sf_degree > 1:
            res = ev.rescale(res)
        return res
