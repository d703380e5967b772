"""The frozen work model: the NTT's least bytes, a key counted once per
key switch, and image_mfu's arithmetic on a fixed op log, each against a
value worked out by hand."""

import math
import types

import pytest

import fhb_util  # noqa: F401  (puts the repository on sys.path)
from fhebench import cells, work

RING = work.Ring(degree=1 << 15, num_q=34, num_p=12, q_parts=3)
IMAD_PER_S = 132 * 64 * 1.98e9


def test_ntt_bytes_match_the_kernel_bound():
    # 46 limbs of 2^15: input, output, twiddles and their Shoup companions
    assert work.ntt_bytes(46, 1 << 15) == 4 * 46 * 32768 * 8 == 48234496
    assert work.ntt_least_s(46, 1 << 15) == pytest.approx(48234496 / 3.35e12)
    assert round(work.ntt_least_s(46, 1 << 15) * 1e3, 4) == 0.0144


def test_digits():
    assert RING.alpha == 12
    assert RING.digits(34) == [12, 12, 10]
    assert RING.digits(12) == [12]
    assert RING.digits(13) == [12, 1]


def test_a_key_switch_reads_its_key_once():
    key = 2 * 3 * (34 + 12)             # two polys per digit, l + K limbs
    assert work.key_words(RING, 34) == key == 276
    rot = work.cost({"kind": "rotate", "level": 34}, RING)
    assert rot.words == 4 * 34 + key    # ciphertext in and out, key once
    mul = work.cost({"kind": "mul", "level": 34}, RING)
    assert mul.words == 6 * 34 + key
    # a bundle of three rotations of one ciphertext reads three keys and
    # raises its input once
    one = work.cost({"kind": "rot_mac_groups", "level": 34, "rotations": 1,
                     "groups": 1, "plaintexts": 1}, RING)
    three = work.cost({"kind": "rot_mac_groups", "level": 34,
                       "rotations": 3, "groups": 1, "plaintexts": 1}, RING)
    assert three.words - one.words == 2 * key
    assert three.ntt == one.ntt


def test_image_mfu_on_a_fixed_op_log():
    log = [{"kind": "rotate", "level": 34, "count": 100},
           {"kind": "rescale", "level": 20, "count": 50}]
    # by hand: a rotation at 34 transforms 34 + (34 + 34 + 36) limbs to
    # raise and 2 x (12 + 34) to bring down (230); converts 12*34 +
    # 12*34 + 10*36 + 2*12*34 = 1992 limb pairs; 276 key products; 68
    # P^-1 products. A rescale at 20 transforms 40 limbs, 38 products.
    ntt = 100 * 230 + 50 * 40
    base_conv = 100 * 1992
    barrett = 100 * 276
    shoup = 100 * 68 + 50 * 38
    words = 100 * (4 * 34 + 276) + 50 * (2 * 20 + 2 * 19)
    imads = ntt * 16384 * 15 * 10 + 32768 * (base_conv * 7 + barrett * 31
                                             + shoup * 10)
    least = max(words * 32768 * 8 / 3.35e12, imads / IMAD_PER_S)
    assert least == imads / IMAD_PER_S      # bound by operations
    total = work.total(log, RING)
    assert total.words == words and total.ntt == ntt
    assert total.least_s(RING) == (pytest.approx(least), "operations")
    run = types.SimpleNamespace(cuda=True, s_per_image=2.0, work=total,
                                ring=RING)
    mfu = cells.reader("image_mfu")(run)
    assert mfu == pytest.approx(100 * least / 2.0)
    assert math.isclose(mfu, 0.41256, rel_tol=1e-4)


@pytest.mark.parametrize("rec", [
    {"kind": "add", "level": 10}, {"kind": "mul_plain", "level": 10,
                                    "num_p": 12},
    {"kind": "rot_sum", "level": 10, "inputs": 4, "rotations": 3},
    {"kind": "rotations_hoisted", "level": 10, "rotations": 2},
    {"kind": "rot_mac_groups_msgs", "level": 10, "rotations": 5,
     "groups": 2, "messages": 12},
    {"kind": "bsgs", "level": 30, "rotations": 3, "giant_switches": 3,
     "messages": 16},
    {"kind": "encrypt", "level": 3}, {"kind": "decrypt", "level": 3},
    {"kind": "mod_raise", "level": 34}])
def test_every_kind_has_positive_work(rec):
    w = work.cost(rec, RING)
    assert w.words > 0 and w.least_s(RING)[0] > 0
