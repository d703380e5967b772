"""Rank functions of the port's SPMD tests (tests/test_torch_parallel.py,
tests/test_torch_spmd.py). The ranks are spawned processes that import
this module by name, so it imports torch and the port only, never jax:
the tests compute ace_tpu's side in the parent and pass numpy arrays in
and out."""

import numpy as np
import torch

from ace_tpu_torch import interop
from ace_tpu_torch.ckks.cipher import Ciphertext3
from ace_tpu_torch.ckks.encoder import Encoder
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops
from ace_tpu_torch.parallel import sharded_ntt as SN
from ace_tpu_torch.parallel.mesh import DigitSlotMesh
from ace_tpu_torch.parallel.spmd import SpmdKeySwitch
from ace_tpu_torch.parallel.spmd_eval import SpmdEvaluator

CPU = torch.device("cpu")


def _mesh(world_mesh, meshes: dict, digits: int, slots: int):
    """A digits x slots mesh over the same world, made once (every rank
    asks for the meshes in the same order)."""
    if (digits, slots) == (world_mesh.num_digits, world_mesh.num_slot):
        return world_mesh
    if (digits, slots) not in meshes:
        meshes[digits, slots] = DigitSlotMesh(digits, slots, "gloo", CPU)
    return meshes[digits, slots]


def ct_arrays(ct) -> tuple:
    return modops.to_numpy(ct.c0.data), modops.to_numpy(ct.c1.data)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def mesh_layouts(mesh, shapes):
    """Each shape's (digit, slot) coordinate and group ranks."""
    meshes = {}
    out = []
    for digits, slots in shapes:
        m = _mesh(mesh, meshes, digits, slots)
        out.append({"rank": m.rank, "digit": m.digit, "slot": m.slot,
                    "shape": m.shape, "groups": m.group_ranks()})
    return out


def sharded_ntts(mesh, cases):
    """cases: (n, slots, primes, x uint64 [L, n]); each gives the sharded
    forward and inverse NTT of x and the inverse of the forward, over a
    (world / slots) x slots mesh."""
    meshes = {}
    world = mesh.num_digits * mesh.num_slot
    out = []
    for n, slots, primes, x in cases:
        m = _mesh(mesh, meshes, world // slots, slots)
        t = SN.make_sharded_ntt_tables(primes, n, CPU)
        xt = modops.to_torch(x, CPU)
        fwd = SN.sharded_ntt_fwd(xt, t, m)
        out.append({"fwd": modops.to_numpy(fwd),
                    "inv": modops.to_numpy(SN.sharded_ntt_inv(xt, t, m)),
                    "back": modops.to_numpy(SN.sharded_ntt_inv(fwd, t, m))})
    return out


def failing_rank(mesh, bad_rank):
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    return mesh.rank


# ---------------------------------------------------------------------------
# tests/test_torch_spmd.py
# ---------------------------------------------------------------------------

def _port(case):
    """The port's params (CPU) and a KeyGenerator holding the case's
    injected ace_tpu keys."""
    params = CkksParams(**case["params"], device="cpu")
    kg = interop.keygen(params, *case["keys"])
    return params, kg


def _ct(arrays, meta):
    return interop.ciphertext(*arrays, *meta, CPU)


def key_switches(mesh, cases):
    """Each case: SpmdKeySwitch.rotate of its ciphertext and relinearize
    of its 3-term ciphertext on a digits x slots mesh, and the resident
    key bytes after both."""
    meshes = {}
    out = []
    for case in cases:
        m = _mesh(mesh, meshes, case["digits"], case["slots"])
        params, kg = _port(case)
        ct = _ct(case["ct"], case["meta"])
        ksw = SpmdKeySwitch(params, ct.level, m)
        rot = ksw.rotate(ct, case["rotation"], kg)
        c0, c1, c2 = (interop.poly(a, ct.level, 0, True, CPU)
                      for a in case["c3"])
        rel = ksw.relinearize(Ciphertext3(c0, c1, c2, *case["meta3"]), kg)
        out.append({"rotate": ct_arrays(rot), "relinearize": ct_arrays(rel),
                    "resident": ksw.key_memory_resident_bytes(),
                    "switches": ksw.switches})
    return out


def conv_slice(ev, enc, ct, n: int):
    """tests/test_spmd_eval.py's slice on an encrypted input: a 3-tap
    conv (rotate -> plaintext MAC -> rescale), then square + relin and
    rescale. Written against the API both packages share, so the test
    runs it on ace_tpu's evaluator too."""
    taps = [enc.encode(np.full(n, w, np.complex128), level=ct.level)
            for w in (0.25, -0.5, 0.125)]
    acc = ev.mul_plain(ct, taps[0])
    for r, t in ((1, taps[1]), (2, taps[2])):
        acc = ev.add(acc, ev.mul_plain(ev.rotate(ct, r), t))
    acc = ev.rescale(acc)
    return ev.rescale(ev.mul(acc, acc))


def spmd_evaluator(mesh, case):
    """tests/test_spmd_eval.py's three cases through SpmdEvaluator with
    the injected keys and ciphertexts."""
    params, kg = _port(case)
    m = _mesh(mesh, {}, case["digits"], case["slots"])
    ev = SpmdEvaluator(params, kg, Encoder(params), m)
    ct = _ct(case["ct"], case["meta"])
    low = _ct(case["ct_low"], case["meta_low"])
    n = params.degree // 2
    out = {"rotate": ct_arrays(ev.rotate(ct, 3)),
           "mul": ct_arrays(ev.mul(ct, ct)),
           "relinearize": ct_arrays(ev.relinearize(ev.mul3(ct, ct))),
           "conv": ct_arrays(conv_slice(ev, ev.encoder, ct, n)),
           "low_is_fallback": ev._ksw(low.level) is None,
           "low_rotate": ct_arrays(ev.rotate(low, 1)),
           "report": ev.key_residency_report(),
           "switches": ev.spmd_switches}
    return out


def jobs(mesh, calls):
    """Run several of the functions above in one world: calls is a list
    of (function name, args); returns their results in order."""
    return [globals()[name](mesh, *args) for name, args in calls]
