"""Scheme-info analysis: choose CKKS parameters from the NN graph.

TPU-native re-implementation of the reference's parameter-policy layer:
  - per-op mul-depth table          fhe-cmplr/core/src/scheme_info_ana.cxx:21-35
  - HE-standard modulus bounds      scheme_info_ana.cxx:44-51 (128/192/256-bit)
  - poly-degree fixed point         scheme_info_ana.cxx:104-130
  - first-prime/scale-bit policy    fhe-cmplr/core/src/scheme_info.cxx:49-97
  - bootstrap depth 15/19 by sk hamming weight  scheme_info.cxx:30-36,121-128
  - P-prime count                   scheme_info.cxx:131-137

The analysis walks the NNGraph (our onnx_front output) instead of an AIR
visitor; levels accumulate along the data flow exactly like the
reference's per-SSA-version max (core/src/ctx_param_ana.cxx:40-60).
"""

from __future__ import annotations

import dataclasses
import math

HAMMING_WEIGHT_THRESHOLD = 192
BOOTSTRAP_MUL_DEPTH_UNDER_THRESHOLD = 15
BOOTSTRAP_MUL_DEPTH_ABOVE_THRESHOLD = 19
HIGH_MUL_LEVEL_THRESHOLD = 18
BIT_NUM_OF_P_PRIME = 60
LEAST_POLY_DEG_POW = 3

# scheme_info_ana.cxx:21-35 (Mul_level_of_nn_op)
MUL_LEVEL_OF_NN_OP = {
    "Add": 0,
    "AveragePool": 1,
    "Conv": 4,
    "Flatten": 1,
    "Gemm": 1,
    "GlobalAveragePool": 1,
    "MaxPool": 1,
    "Mul": 1,
    "Relu": 9,
    "Reshape": 0,
    "StridedSlice": 2,
    "Sub": 0,
}

# scheme_info_ana.cxx:44-51 (Mod_info): max modulus bits for poly degree
# 2^10..2^16 at each classical security level.
MODULUS_BOUNDS = {
    0: None,  # HE_STD_NOT_SET: unconstrained
    128: [27, 54, 109, 218, 438, 881, 1772],
    192: [19, 37, 75, 152, 305, 611, 1228],
    256: [14, 29, 58, 118, 237, 476, 956],
}
_BOUNDS_FIRST_POW = 10  # table index 0 is poly degree 2^10

# scheme_info.cxx:49-72: (first_prime_bits, scale_bits)
LOW_MUL_LEVEL_PRIME_INFO = (33, 30)
HIGH_MUL_LEVEL_PRIME_INFO = [          # indexed by log2(degree) - 3
    (60, 50), (60, 51), (60, 51), (60, 53), (60, 54), (60, 54), (60, 54),
    (60, 56), (60, 58), (60, 58), (60, 59), (60, 59), (60, 59), (60, 59),
]


def bootstrap_mul_depth(hamming_weight: int) -> int:
    """scheme_info.cxx:121-128 (Mul_depth_of_bootstrap)."""
    if 0 < hamming_weight <= HAMMING_WEIGHT_THRESHOLD:
        return BOOTSTRAP_MUL_DEPTH_UNDER_THRESHOLD
    return BOOTSTRAP_MUL_DEPTH_ABOVE_THRESHOLD


@dataclasses.dataclass
class SchemeConfig:
    """User-facing knobs (the reference's -CKKS:/-SIHE: option groups)."""
    security_level: int = 128        # 0 = unconstrained (test params)
    hamming_weight: int = 0          # 0 = uniform ternary secret
    first_mod_size: int = 0          # 0 = policy default (-CKKS:q0)
    scaling_mod_size: int = 0        # 0 = policy default (-CKKS:sf)
    relu_mul_depth: int = 13         # composite sign depth (-SIHE)
    relu_value_range: float = 3.0    # default per-ReLU input range
    relu_ranges: dict = dataclasses.field(default_factory=dict)
    use_bootstrap: bool = True       # refresh levels before each ReLU


@dataclasses.dataclass
class SchemeInfo:
    poly_degree: int
    mul_level: int                   # number of q primes = mul depth + 1
    first_mod_size: int
    scaling_mod_size: int
    q_part_num: int
    p_prime_num: int
    security_level: int
    hamming_weight: int
    max_msg_len: int
    bootstrap_depth: int
    rotate_indices: tuple = ()
    input_level: int = 0             # minimal encryption level (0 = top)


def _msg_len(shape) -> int:
    n = 1
    for d in shape or ():
        n *= max(int(d), 1)
    return n


def _slots_needed(op, graph) -> int:
    """Packed-slot requirement of one op, including the duplication
    space the metakernels need (the analog of the VECTOR pass growing
    message length: input-dup in New_conv_metakernel,
    tensor2vector_util.cxx:163-305, needs 2x the output block)."""
    out = _msg_len(op.out_shape)
    if op.op_type == "Conv" and op.in_shape and len(op.in_shape) == 4:
        cin = op.in_shape[1]
        cout = op.out_shape[1]
        # conv runs at the *input* resolution; stride compaction happens
        # after the metakernel (compiler/packing.py conv2d)
        hw = op.in_shape[2] * op.in_shape[3]
        if cout >= cin:
            # fast path works at L = c_out'*hw slots per output-channel
            # chunk; channel-expanding convs split into chunks of c_in
            # channels (conv2d's split branch), so the ring only needs
            # the input block — unlike the reference, whose explicit-dup
            # metakernel forces 2*c_out*hw (hence its N=2^16 for ResNet
            # vs our 2^15)
            return cin * hw
        import math as _m
        copies = max(_m.ceil((cout + cin) / cin), 2)
        return cin * hw * copies
    if op.op_type == "Gemm":
        return 2 * _msg_len(op.in_shape)
    return out


def analyze_graph_depth(graph, cfg: SchemeConfig) -> tuple[int, int]:
    """(max accumulated mul level, max msg len) over the NN graph.

    Mirrors SCHEME_INFO_ANA's per-value max accumulation. With
    bootstrapping enabled the level restarts at each ReLU (the SIHE
    pass inserts SIHE.bootstrap before every ReLU,
    tensor2sihe_impl.h:133-176), so the program's required depth is the
    deepest bootstrap-to-bootstrap segment plus the bootstrap's own
    consumption, exactly the budget rtlib re-raises to.
    """
    relu_depth = cfg.relu_mul_depth
    level = {graph.input_name: 0}
    max_level = 0
    max_msg = _msg_len(graph.input_shape)
    for op in graph.ops:
        lv_in = max(level.get(name, 0) for name in op.inputs)
        depth = MUL_LEVEL_OF_NN_OP.get(op.op_type, 0)
        if op.op_type == "Relu":
            depth = relu_depth + 1  # sign chain + final 0.5*x*(s+1) mul
            if cfg.use_bootstrap:
                lv_in = 0           # fresh budget after bootstrap
        lv_out = lv_in + depth
        max_level = max(max_level, lv_out)
        level[op.outputs[0]] = lv_out
        max_msg = max(max_msg, _slots_needed(op, graph))
    return max_level, max_msg


def q_part_num_policy(mul_level: int) -> int:
    """scheme_info.cxx:90-96."""
    if mul_level > 3:
        return 3
    if mul_level == 0:
        return 1
    return 2


def p_prime_num(mul_level: int, q_part_num: int, first_bits: int,
                scale_bits: int) -> int:
    """scheme_info.cxx:131-137 (Get_p_prime_num)."""
    num_per_part = math.ceil(mul_level / q_part_num)
    bit_num = first_bits + (num_per_part - 1) * scale_bits
    return math.ceil(bit_num / BIT_NUM_OF_P_PRIME)


def prime_info_policy(mul_level: int, poly_degree: int) -> tuple[int, int]:
    """scheme_info.cxx:74-88 (Update_prime_info step 1)."""
    if mul_level >= HIGH_MUL_LEVEL_THRESHOLD:
        pow2 = round(math.log2(poly_degree))
        return HIGH_MUL_LEVEL_PRIME_INFO[
            min(pow2, 16) - LEAST_POLY_DEG_POW]
    return LOW_MUL_LEVEL_PRIME_INFO


def modulus_bit_num(mul_level: int, first_bits: int, scale_bits: int,
                    q_parts: int) -> int:
    """scheme_info.cxx:139-147 (Get_modulus_bit_num)."""
    bits = first_bits
    if mul_level > 1:
        bits += (mul_level - 1) * scale_bits
    bits += p_prime_num(mul_level, q_parts, first_bits,
                        scale_bits) * BIT_NUM_OF_P_PRIME
    return bits


def min_poly_degree_for_bits(bits: int, security_level: int) -> int:
    """Smallest 2^k whose HE-standard bound covers `bits`
    (scheme_info_ana.cxx Min_poly_deg)."""
    bounds = MODULUS_BOUNDS[security_level]
    for i, bound in enumerate(bounds):
        if bits <= bound:
            return 1 << (_BOUNDS_FIRST_POW + i)
    raise ValueError(f"modulus {bits} bits exceeds security table")


def security_posture(info: SchemeInfo) -> dict:
    """Honest classification of a parameter set against the HE-standard
    modulus tables (fhe_std_parms.h:76-106 analog, MODULUS_BOUNDS).

    Returns {bits, degree, level: 128|192|256|0, compliant, detail};
    level is the strongest HE-std classical level the (degree, QP-bits)
    pair satisfies, 0 if none. Benchmarks must surface this — a timing
    at a non-compliant parameter set is a perf datapoint, not a secure-
    inference claim."""
    bits = modulus_bit_num(info.mul_level + 1, info.first_mod_size,
                           info.scaling_mod_size, info.q_part_num)
    idx = round(math.log2(info.poly_degree)) - _BOUNDS_FIRST_POW
    level = 0
    for lv in (256, 192, 128):
        tab = MODULUS_BOUNDS[lv]
        if 0 <= idx < len(tab) and bits <= tab[idx]:
            level = lv
            break
    if level:
        detail = f"{level}-bit classical (HE-std): QP={bits} bits " \
                 f"at N=2^{idx + _BOUNDS_FIRST_POW}"
    else:
        need = None
        tab = MODULUS_BOUNDS[128]
        for i, bound in enumerate(tab):
            if bits <= bound:
                need = 1 << (_BOUNDS_FIRST_POW + i)
                break
        detail = (f"NOT HE-std compliant: QP={bits} bits at "
                  f"N=2^{idx + _BOUNDS_FIRST_POW} "
                  + (f"needs N>={need} for 128-bit classical"
                     if need else "exceeds every table row"))
    return {"bits": bits, "degree": info.poly_degree, "level": level,
            "compliant": bool(level), "detail": detail}


def select_params(graph, cfg: SchemeConfig | None = None) -> SchemeInfo:
    """The full SCHEME_INFO_ANA::Run policy for one NN graph.

    Depth comes from exact symbolic execution of the packed program
    (level_sim.required_levels) rather than the reference's hand-kept
    per-op constants, so the selected chain can never underrun our
    metakernels' true rescale counts."""
    from ace_tpu_torch.compiler import level_sim

    cfg = cfg or SchemeConfig()
    _, msg_len = analyze_graph_depth(graph, cfg)

    # minimum degree to pack the longest message (msg_len <= N/2)
    poly_degree = 2 << math.ceil(math.log2(max(msg_len, 2)))

    from ace_tpu_torch.compiler.packing import SlotOverflow

    def sim_levels(degree):
        return level_sim.segment_levels(
            graph, degree // 2, relu_ranges=cfg.relu_ranges,
            relu_range_default=cfg.relu_value_range,
            relu_mul_depth=cfg.relu_mul_depth,
            use_bootstrap=cfg.use_bootstrap)

    while True:
        try:
            segments = sim_levels(poly_degree)
            break
        except SlotOverflow:
            poly_degree *= 2  # packing needed more slot headroom
    segment = max(segments)

    def total_level(seg):
        lv = seg
        if cfg.use_bootstrap:
            lv += level_sim.bootstrap_depth(cfg.hamming_weight)
        return lv

    mul_level = total_level(segment)

    if cfg.security_level:
        prev = 0
        while prev != poly_degree:
            prev = poly_degree
            first, scale = prime_info_policy(mul_level, poly_degree)
            if cfg.first_mod_size:
                first = cfg.first_mod_size
            if cfg.scaling_mod_size:
                scale = cfg.scaling_mod_size
            q_parts = q_part_num_policy(mul_level)
            bits = modulus_bit_num(mul_level, first, scale, q_parts)
            grown = max(poly_degree,
                        min_poly_degree_for_bits(bits, cfg.security_level))
            if grown != poly_degree:
                # re-simulate at the larger slot count: the packed
                # program's level consumption may differ per degree
                poly_degree = grown
                segments = sim_levels(poly_degree)
                mul_level = total_level(max(segments))

    first, scale = prime_info_policy(mul_level, poly_degree)
    if cfg.first_mod_size:
        first = cfg.first_mod_size
    if cfg.scaling_mod_size:
        scale = cfg.scaling_mod_size
    q_parts = q_part_num_policy(mul_level)
    return SchemeInfo(
        poly_degree=poly_degree,
        mul_level=mul_level,
        first_mod_size=first,
        scaling_mod_size=scale,
        q_part_num=q_parts,
        p_prime_num=p_prime_num(mul_level, q_parts, first, scale),
        security_level=cfg.security_level,
        hamming_weight=cfg.hamming_weight,
        max_msg_len=msg_len,
        bootstrap_depth=(bootstrap_mul_depth(cfg.hamming_weight)
                         if cfg.use_bootstrap else 0),
        # the first bootstrap drops to the last tower regardless of the
        # input level, so encrypting at segment0-consumption + 1 levels
        # is exact: every pre-bootstrap op compiles and executes at a
        # fraction of the full chain (ctx_param_ana's input-level analog)
        input_level=(segments[0] + 1 if cfg.use_bootstrap
                     else mul_level + 1),
    )
