"""The least work of the homomorphic operations, frozen with the
benchmark: a later change to the program cannot move it.

Each operation is counted from its kind and shapes alone, whatever
kernels implement it:
- bytes: every ciphertext, key, plaintext and message word read once and
  every output word written once, 8 bytes a word; intermediates are free;
- NTT: (N/2) log2 N butterflies per limb transformed, each a Shoup
  product;
- base conversion: limbs_in x limbs_out x N products, each a 64 x 64 ->
  128-bit product (its accumulation and final reduction are free);
- the other modular products (ciphertext by key, plaintext or ciphertext)
  are Barrett products, products by constants known in advance Shoup
  products.
The least time is the larger of the bytes over the card's memory
bandwidth and the 32-bit IMADs over its integer rate (H100 SXM, NVIDIA's
data sheet; the IMAD rate is the CUDA-core float32 rate of 67 TFLOP/s =
132 SMs x 128 lanes x 2 x 1.98 GHz on half the lanes).

A hybrid key switch of one polynomial at level l (l q limbs, K P limbs,
digits of alpha limbs, D = ceil(l / alpha) of them at l) inverse-
transforms its input, raises each digit to the other l + K - a_d limbs
and transforms them, multiplies the D raised digits by the two key
polynomials over l + K limbs, and brings both products down to l limbs
(inverse NTT of K limbs, K x l base conversion, NTT of l limbs and a
product by P^-1 each).
"""

from __future__ import annotations

import dataclasses
import math

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
WORD_BYTES = 8
# 32-bit IMADs per 64-bit product: low word 3, high word 4
MUL_LO, MUL_HI = 3, 4
SHOUP_IMAD = MUL_HI + 2 * MUL_LO
BARRETT_IMAD = (MUL_HI + MUL_LO) + MUL_HI + 2 * (MUL_HI + MUL_LO) \
    + 2 * MUL_LO
BASE_CONV_IMAD = MUL_HI + MUL_LO


@dataclasses.dataclass(frozen=True)
class Ring:
    degree: int     # N
    num_q: int      # q limbs at the top of the chain
    num_p: int      # P limbs (K)
    q_parts: int    # digits at the top of the chain

    @property
    def alpha(self) -> int:
        return math.ceil(self.num_q / self.q_parts)

    def digits(self, level: int) -> list:
        """Limbs of each digit at `level`."""
        return [min(self.alpha, level - s) for s in range(0, level,
                                                          self.alpha)]


@dataclasses.dataclass
class Work:
    """Counts in limbs (multiply by N for words, transforms or products)."""
    words: float = 0.0          # words read or written
    ntt: float = 0.0            # limbs transformed
    base_conv: float = 0.0      # limbs_in x limbs_out summed
    mod_mul: float = 0.0        # Barrett products
    const_mul: float = 0.0      # Shoup products

    def __iadd__(self, o: "Work") -> "Work":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))
        return self

    def __add__(self, o: "Work") -> "Work":
        out = Work(**dataclasses.asdict(self))
        out += o
        return out

    def scaled(self, k: float) -> "Work":
        return Work(*(k * getattr(self, f.name)
                      for f in dataclasses.fields(self)))

    def nbytes(self, ring: Ring) -> float:
        return self.words * ring.degree * WORD_BYTES

    def imads(self, ring: Ring) -> float:
        n = ring.degree
        butterflies = self.ntt * (n // 2) * math.log2(n)
        return (butterflies * SHOUP_IMAD
                + n * (self.base_conv * BASE_CONV_IMAD
                       + self.mod_mul * BARRETT_IMAD
                       + self.const_mul * SHOUP_IMAD))

    def least_s(self, ring: Ring) -> tuple:
        """(least seconds, "bytes" or "operations": which bounds it)."""
        tb = self.nbytes(ring) / HBM_BYTES_PER_S
        to = self.imads(ring) / IMAD_PER_S
        return (tb, "bytes") if tb >= to else (to, "operations")


def ntt_bytes(limbs: int, degree: int) -> int:
    """Least bytes of a limb-wise NTT: input, output and the twiddle
    table and its Shoup companion, one word each per coefficient."""
    return 4 * limbs * degree * WORD_BYTES


def ntt_least_s(limbs: int, degree: int) -> float:
    """Least seconds of `limbs` limb transforms at `degree`."""
    ops = limbs * SHOUP_IMAD * (degree // 2) * math.log2(degree)
    return max(ntt_bytes(limbs, degree) / HBM_BYTES_PER_S, ops / IMAD_PER_S)


def key_words(ring: Ring, level: int) -> int:
    """Limbs of one switching key used at `level`: two polynomials of
    l + K limbs per digit."""
    return 2 * len(ring.digits(level)) * (level + ring.num_p)


def _raise(ring: Ring, level: int) -> Work:
    """Inverse NTT of the input, and each digit raised and transformed."""
    k = ring.num_p
    ds = ring.digits(level)
    return Work(ntt=level + sum(level + k - a for a in ds),
                base_conv=sum(a * (level + k - a) for a in ds))


def _mac(ring: Ring, level: int) -> Work:
    """The raised digits against one key: the key read once."""
    return Work(words=key_words(ring, level),
                mod_mul=key_words(ring, level))


def _down(ring: Ring, level: int) -> Work:
    """One polynomial from l + K limbs down to l."""
    k = ring.num_p
    return Work(ntt=k + level, base_conv=k * level, const_mul=level)


def key_switch(ring: Ring, level: int) -> Work:
    """One key switch of one polynomial (its input and outputs are the
    caller's words)."""
    w = _raise(ring, level)
    w += _mac(ring, level)
    w += _down(ring, level).scaled(2)
    return w


def cost(rec: dict, ring: Ring) -> Work:
    """The least work of one operation of the op log (port.OpLog)."""
    kind, lv = rec["kind"], rec["level"]
    k = ring.num_p
    ext = lv + k
    if kind in ("add", "sub"):
        return Work(words=6 * lv)
    if kind == "negate":
        return Work(words=4 * lv)
    if kind in ("add_plain", "sub_plain"):
        return Work(words=3 * lv)
    if kind == "add_const":
        return Work(words=2 * lv)
    if kind in ("mul_const", "mul_integer", "upscale"):
        return Work(words=4 * lv, const_mul=2 * lv)
    if kind == "mul_by_monomial":
        return Work(words=4 * lv, mod_mul=2 * lv)
    if kind == "mul_plain":
        lp = lv + rec.get("num_p", 0)
        return Work(words=5 * lp, mod_mul=2 * lp)
    if kind == "rescale":
        return Work(words=2 * lv + 2 * (lv - 1), ntt=2 * lv,
                    const_mul=2 * (lv - 1))
    if kind == "mul":
        w = Work(words=6 * lv, mod_mul=4 * lv)
        w += key_switch(ring, lv)
        return w
    if kind == "rotate":
        w = Work(words=4 * lv)
        w += key_switch(ring, lv)
        return w
    if kind == "encrypt":
        return Work(words=5 * lv, ntt=3 * lv, mod_mul=2 * lv)
    if kind == "decrypt":
        return Work(words=4 * lv, mod_mul=lv)
    if kind == "mod_raise":
        return Work(words=2 + 2 * lv, ntt=2 + 2 * lv)
    if kind == "rot_sum":
        # each input raised and switched on its own, summed in QP, one
        # mod-down per component
        r = rec["rotations"]
        w = Work(words=2 * lv * rec["inputs"] + 2 * lv,
                 const_mul=lv * rec["inputs"])
        w += (_raise(ring, lv) + _mac(ring, lv)).scaled(r) \
            if r else Work()
        w += _down(ring, lv).scaled(2)
        return w
    if kind == "rotations_hoisted":
        r = rec["rotations"]
        w = Work(words=2 * lv + 2 * lv * r)
        if r:
            w += _raise(ring, lv)
            w += (_mac(ring, lv) + _down(ring, lv).scaled(2)).scaled(r)
        return w
    if kind in ("rot_mac_groups", "rot_mac_groups_msgs"):
        # one shared raise; each group: its plaintexts (QP limbs, or one
        # word per message, lifted and transformed) by the rotations,
        # then one mod-down per component
        r, g = rec["rotations"], rec["groups"]
        w = Work(words=2 * lv + 2 * lv * g, const_mul=lv)
        if r:
            w += _raise(ring, lv)
            w += _mac(ring, lv).scaled(r)
        if kind == "rot_mac_groups":
            p = rec["plaintexts"]
            w += Work(words=p * ext, mod_mul=2 * p * ext)
        else:
            m = rec["messages"]
            w += Work(words=m, ntt=m * ext, mod_mul=2 * m * ext)
        w += _down(ring, lv).scaled(2 * g)
        return w
    if kind == "bsgs":
        # baby rotations share one raise; each giant group's messages
        # multiply them in QP; every giant step after the first
        # brings its c1 down and switches it; two final mod-downs
        b, gs, m = rec["rotations"], rec["giant_switches"], rec["messages"]
        w = Work(words=4 * lv + m, const_mul=lv, ntt=m * ext,
                 mod_mul=2 * m * ext)
        if b:
            w += _raise(ring, lv)
            w += _mac(ring, lv).scaled(b)
        w += (_down(ring, lv) + key_switch(ring, lv)).scaled(gs)
        w += _down(ring, lv).scaled(2)
        return w
    raise KeyError(f"no work model for operation {kind!r}")


def total(log: list, ring: Ring) -> Work:
    out = Work()
    for rec in log:
        out += cost(rec, ring).scaled(rec.get("count", 1))
    return out
