"""PyTorch port: kernel K5, fast base conversion (csrc/baseconv.cu,
ops/baseconv.py), behind every mod-up and mod-down.

The CPU tests check the conversions K5 is handed (its 128-bit accumulator
cannot overflow at the cell's ring or at ACE's N = 2^16 ring), a model of
the kernel's slicing and constant layout against the plain version
(baseconv.base_conv_plain, which reads the kernel's packed constants),
the plain version against ace_tpu's _base_conv_data, and that CPU
tensors take the plain version without building a library. The `gpu`
tests hold K5 word for word to the plain version run on the CPU, inside
captured op programs too, and count its launches under the profiler.
This file imports neither jax nor ace_tpu at import (only the test that
compares with ace_tpu does), so it also runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_baseconv.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from ace_tpu_torch import ops
from ace_tpu_torch.ops import baseconv, kernels, modops as TM
from ace_tpu_torch.parallel.spmd import window_constants
from ace_tpu_torch.poly import poly as P
from ace_tpu_torch.poly.rns import CrtContext

# ResNet-20's ring (the benchmark's cell): 34 q + 12 P primes, 3 digits
CELL = dict(num_q=34, first_mod_size=60, scaling_mod_size=56,
            degree=1 << 15, num_q_parts=3)
# ACE's own ResNet-20 ring (SECURITY.md): 34 q + 11 P primes, 3 digits
ACE_2E16 = dict(num_q=34, first_mod_size=51, scaling_mod_size=50,
                degree=1 << 16, num_q_parts=3)
RINGS = {"cell": CELL, "ace_2e16": ACE_2E16}

_crts = {}


def _crt(ring: str, device: str = "cpu") -> CrtContext:
    key = (ring, device)
    if key not in _crts:
        _crts[key] = CrtContext(**RINGS[ring], device=device)
    return _crts[key]


def _mod_up_conv(crt, level: int, part: int):
    """(old_qs, new_qs, hat_inv, mat [new][old]) of mod_up's conversion of
    digit `part` at `level` live q limbs (poly.decompose / mod_up)."""
    per = crt.per_part_size
    sz = (level - per * part if part == crt.num_decomp(level) - 1
          else len(crt.parts[part]))
    compl = crt.compl_indices[level - 1][part]
    m = crt.part_hat_mod_compl[level - 1][part]
    return (crt.parts[part][:sz], [crt.all_primes[g] for g in compl],
            crt.part_hat_inv_mod_q[part][sz - 1],
            [[m[i][j] for i in range(sz)] for j in range(len(compl))])


def _mod_down_conv(crt, level: int):
    """mod_down's P -> q[:level] conversion."""
    return (crt.p_primes, crt.q_primes[:level], crt.p_hat_inv_mod_p,
            crt.p_hat_mod_q[:level])


def _spmd_conv(crt, level: int, d: int):
    """The SPMD key switch's conversion of digit d's window to the whole
    live QP basis (SpmdKeySwitch's window_qs, qp_primes, ...)."""
    w = window_constants(crt, level)
    return ([int(q) for q in w["part_q"][d]],
            list(crt.q_primes[:level]) + list(crt.p_primes),
            [int(v) for v in w["hat_inv"][d]],
            [[int(v) for v in row] for row in w["mat"][d]])


def _every_conversion(crt, kind: str):
    if kind == "mod_up":
        for level in range(1, crt.num_q + 1):
            for part in range(crt.num_decomp(level)):
                yield _mod_up_conv(crt, level, part)
    elif kind == "mod_down":
        for level in range(1, crt.num_q + 1):
            yield _mod_down_conv(crt, level)
    else:
        for level in range(crt.per_part_size, crt.num_q + 1):
            for d in range(crt.num_decomp(level)):
                yield _spmd_conv(crt, level, d)


def _plain(x, conv):
    """The plain version on the conversion (old, new, hat_inv, mat)."""
    return baseconv.base_conv_plain(
        x, TM.to_torch(baseconv.constants(*conv), x.device), len(conv[1]))


def _residues(primes, n, seed):
    rng = np.random.default_rng(seed)
    return TM.to_torch(np.stack([rng.integers(0, q, n, dtype=np.uint64)
                                 for q in primes]))


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mod_up", "mod_down", "spmd"])
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_accumulator_never_overflows(ring, kind):
    """K5's precondition, O * (max q_o - 1) * (max matrix entry) < 2^128,
    holds for every conversion the ring's CrtContext makes: each digit's
    mod-up at every level, mod-down at every level, and each digit window
    of the SPMD key switch; each packs into K5's constants."""
    crt = _crt(ring)
    seen = 0
    for old, new, hat_inv, mat in _every_conversion(crt, kind):
        assert len(mat) == len(new) and all(len(r) == len(old) for r in mat)
        assert baseconv.accumulator_bound(old, mat) < 1 << 128
        c = baseconv.constants(old, new, hat_inv, mat)
        assert c.shape == (3 * len(old) + (len(old) + 3) * len(new),)
        seen += 1
    assert seen >= crt.num_q


def test_overflowing_conversion_is_refused():
    """A conversion whose sum could pass 2^128 raises rather than packs."""
    q = (1 << 61) - 1
    with pytest.raises(ValueError, match="overflow"):
        baseconv.constants([q] * 300, [q], [1] * 300, [[q - 1] * 300])
    with pytest.raises(ValueError, match="source rows"):
        baseconv.constants([17] * (baseconv.MAX_OLD + 1), [13],
                           [1] * (baseconv.MAX_OLD + 1),
                           [[1] * (baseconv.MAX_OLD + 1)])


def _k5_model(x: np.ndarray, c: np.ndarray, nnew: int) -> np.ndarray:
    """csrc/baseconv.cu's arithmetic in Python integers: the packed
    constants read at the kernel's offsets, the target rows cut into the
    launch's slices of R = slice_rows(nnew) rows (the last one partial),
    Shoup, the 128-bit sum and Barrett-128 per slice row."""
    c = [int(v) for v in c]
    O, n = x.shape
    R = baseconv.slice_rows(nnew)
    assert -(-nnew // R) == -(-nnew // baseconv.ROWS)  # the fewest slices
    out = np.zeros((nnew, n), dtype=np.uint64)
    covered = []
    for y in range(-(-nnew // R)):
        j0 = y * R
        rows = min(R, nnew - j0)
        assert 0 < rows <= R <= baseconv.ROWS
        covered += range(j0, j0 + rows)
        for col in range(n):
            t = []
            for o in range(O):
                q, w, wp = c[o], c[O + o], c[2 * O + o]
                xv = int(x[o, col])
                r = (xv * w - ((xv * wp) >> 64) * q) % (1 << 64)
                t.append(r - q if r >= q else r)
            for r in range(rows):
                j = j0 + r
                acc = sum(t[o] * c[3 * O + j * O + o] for o in range(O))
                assert acc < 1 << 128
                p = c[3 * O + nnew * O + j]
                mu = (c[3 * O + nnew * O + nnew + j] << 64) \
                    | c[3 * O + nnew * O + 2 * nnew + j]
                assert mu == (1 << 128) // p
                out[j, col] = acc % p
    assert covered == list(range(nnew))
    return out


@pytest.mark.parametrize("case", ["12->34", "10->36", "1->36", "P->q1",
                                  "P->q34", "spmd"])
def test_kernel_model_matches_plain(case):
    """The model of K5's slicing and constant layout equals the plain
    version at the cell's conversions (a few columns)."""
    crt = _crt("cell")
    conv = {"12->34": lambda: _mod_up_conv(crt, 34, 0),
            "10->36": lambda: _mod_up_conv(crt, 34, 2),
            "1->36": lambda: _mod_up_conv(crt, 25, 2),
            "P->q1": lambda: _mod_down_conv(crt, 1),
            "P->q34": lambda: _mod_down_conv(crt, 34),
            "spmd": lambda: _spmd_conv(crt, 34, 2)}[case]()
    x = _residues(conv[0], 6, 7)
    want = _plain(x, conv)
    got = _k5_model(TM.to_numpy(x), baseconv.constants(*conv), len(conv[1]))
    np.testing.assert_array_equal(got, TM.to_numpy(want))


def test_plain_matches_ace_tpu_at_the_key_switch():
    """The plain version, reading the packed constants, equals ace_tpu's
    _base_conv_data word for word at a small ring's key-switch
    conversions: each digit's mod-up and mod-down at the top level, and
    the last (short) digit's mod-up one level down."""
    import jax.numpy as jnp
    from ace_tpu.poly import poly as AP
    crt = CrtContext(8, 60, 56, 256, 3, device="cpu")
    convs = [_mod_up_conv(crt, 8, d) for d in range(crt.num_decomp(8))] \
        + [_mod_down_conv(crt, 8), _mod_up_conv(crt, 7, 2)]
    for k, conv in enumerate(convs):
        x = _residues(conv[0], crt.degree, 20 + k)
        want = AP._base_conv_data(jnp.asarray(TM.to_numpy(x)), *conv)
        np.testing.assert_array_equal(TM.to_numpy(_plain(x, conv)),
                                      np.asarray(want))


def test_cpu_takes_the_plain_version_and_builds_nothing(monkeypatch):
    """base_conv on CPU tensors is the plain version, launches nothing
    and never builds or loads a kernel library, and so is
    poly._base_conv_data, which calls it. K5 counts launches and, not
    being an NTT, no limbs."""
    def refuse(*a, **k):
        raise AssertionError("a kernel library was built or loaded")
    monkeypatch.setattr(kernels, "build_all", refuse)
    monkeypatch.setattr(kernels, "lib", refuse)
    crt = CrtContext(4, 60, 56, 64, 2, device="cpu")
    conv = _mod_up_conv(crt, 4, 0)
    x = _residues(conv[0], 64, 3)
    ops.reset_counters()
    consts = TM.to_torch(baseconv.constants(*conv))
    got = baseconv.base_conv(x, consts, len(conv[1]))
    assert torch.equal(got, baseconv.base_conv_plain(x, consts, len(conv[1])))
    assert torch.equal(P._base_conv_data(x, *conv, crt), got)
    assert ops.read_counters()["K5"] == 0
    assert "K5" not in ops.read_limbs()


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def cell():
    """The cell's ring on the card and on the CPU."""
    _card()
    return _crt("cell", "cuda"), _crt("cell", "cpu")


def _small(degree):
    key = ("small", degree)
    if key not in _crts:
        _crts[key] = tuple(CrtContext(8, 60, 56, degree, 3, device=d)
                           for d in ("cuda", "cpu"))
    return _crts[key]


CARD_CASES = {
    # name: (conversion of the cell's ring, row length)
    "12->34": (lambda c: _mod_up_conv(c, 34, 0), 1 << 15),
    "12->22": (lambda c: _mod_up_conv(c, 22, 0), 1 << 15),
    "10->36": (lambda c: _mod_up_conv(c, 34, 2), 1 << 15),
    "P12->q34": (lambda c: _mod_down_conv(c, 34), 1 << 15),
    "O=1": (lambda c: _mod_up_conv(c, 25, 2), 1 << 15),
    "one_row": (lambda c: _mod_down_conv(c, 1), 1 << 15),
    "spmd_half": (lambda c: _spmd_conv(c, 34, 2), 1 << 14),
    "ragged": (lambda c: _mod_up_conv(c, 34, 1), 5000),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_k5_equals_plain_on_the_cpu(cell, case):
    """K5 on the card == the plain version on the CPU, word for word, at
    the cell's shapes (12 -> 34, 12 -> 22, 10 -> 36, 12 P -> 34 q at
    N = 2^15), one source row, one target row, an SPMD column shard's
    row length and a row length that is no multiple of a block; one
    launch each."""
    g, c = cell
    make, n = CARD_CASES[case]
    old, new, hat_inv, mat = conv = make(c)
    x = _residues(old, n, 11)
    want = _plain(x, conv)
    before = ops.read_counters()["K5"]
    got = P._base_conv_data(x.cuda(), old, new, hat_inv, mat, g)
    torch.cuda.synchronize()
    assert ops.read_counters()["K5"] == before + 1
    np.testing.assert_array_equal(TM.to_numpy(got.cpu()), TM.to_numpy(want))


@pytest.mark.gpu
def test_k5_at_n_2e11():
    """K5 == the plain version at N = 2^11 (mod-up of each digit, mod-down)."""
    _card()
    g, c = _small(1 << 11)
    convs = [_mod_up_conv(c, 8, d) for d in range(c.num_decomp(8))]
    for conv in convs + [_mod_down_conv(c, 8)]:
        old, new, hat_inv, mat = conv
        x = _residues(old, 1 << 11, len(new))
        want = _plain(x, conv)
        got = P._base_conv_data(x.cuda(), old, new, hat_inv, mat, g)
        np.testing.assert_array_equal(TM.to_numpy(got.cpu()),
                                      TM.to_numpy(want))


def _key_switch_fns(crt, level: int):
    """mod_up of each digit and mod_down at `level`, NTT form, as
    functions of the data: [level, N] and [level + K, N]."""
    def up(d):
        return lambda data: P.mod_up(P.decompose(
            P.RnsPoly(data, level, 0, True), crt, d), crt, level, d).data

    def down(data):
        return P.mod_down(P.RnsPoly(data, level, crt.num_p, True), crt).data
    return [up(d) for d in range(crt.num_decomp(level))] + [down]


@pytest.mark.gpu
def test_mod_up_mod_down_replayed_equal_eager_and_plain(cell):
    """mod_up of each digit and mod_down at the cell's top level, each as
    an op program (call 1 eager, 2 captured, 3 replayed) on fresh inputs:
    every call equal word for word to the eager card path, and the eager
    path to the plain one on the CPU; one K5 launch per conversion, also
    in a replay."""
    from ace_tpu_torch.utils.liftgraph import GraphPool, lift_graph
    g, c = cell
    level, n = 34, c.degree
    fns_g, fns_c = _key_switch_fns(g, level), _key_switch_fns(c, level)
    pool = GraphPool("cuda")
    progs = [lift_graph(f, pool) for f in fns_g]
    rows = [level] * (len(fns_g) - 1) + [level + c.num_p]
    for call in range(3):
        for k, (prog, f_g, f_c) in enumerate(zip(progs, fns_g, fns_c)):
            x = _residues(c.all_primes[:level] if rows[k] == level
                          else c.q_primes[:level] + c.p_primes, n,
                          100 * call + k)
            eager = f_g(x.cuda())
            before = ops.read_counters()["K5"]
            got = prog(x.cuda())
            torch.cuda.synchronize()
            assert ops.read_counters()["K5"] == before + 1
            assert torch.equal(got, eager), (call, k)
            if call == 0:
                np.testing.assert_array_equal(TM.to_numpy(eager.cpu()),
                                              TM.to_numpy(f_c(x)))
    assert pool.captures == len(progs)


@pytest.mark.gpu
def test_each_conversion_is_one_k5_kernel(cell):
    """Under torch.profiler, a key switch's mod-ups and mod-down launch one
    K5 kernel per conversion, each right between the inverse NTT (K4) and
    the forward NTT (K3): no ATen kernel in between."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g, c = cell
    level = 34
    fns = _key_switch_fns(g, level)
    xs = [_residues(c.all_primes[:level], c.degree, 5).cuda()] \
        * (len(fns) - 1) \
        + [_residues(c.q_primes[:level] + c.p_primes, c.degree, 6).cuda()]
    for f, x in zip(fns, xs):  # constants and libraries first
        f(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f, x in zip(fns, xs):
            f(x)
        torch.cuda.synchronize()
    names = [e.name() for e in sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0),
        key=lambda e: e.start_ns())]
    at = [i for i, s in enumerate(names) if "k5_base_conv" in s]
    assert len(at) == len(fns), names
    for i in at:
        assert "ntt_cluster" in names[i - 1] and "ntt_cluster" in names[i + 1], \
            names[i - 1:i + 2]
