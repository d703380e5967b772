"""PyTorch port: the ('dp', 'limb') process mesh and the limb shard
(ace_tpu_torch/parallel/mesh.py make_mesh, put_limb, shard_poly,
replicated; poly/rns.py CrtContext.shard) on a 1 x 4 gloo world of
spawned CPU ranks, with a 2 x 2 mesh made over the same world: the
layout against ace_tpu's make_mesh on conftest's 8 virtual devices,
ownership of limbs across levels, and FheContext(mesh=...) with its own
keys (per-rank key bytes, ranks agreeing with the unsharded keys of the
same seed, a decode). Also the refusals: no CUDA default for a
CrtContext without a card, no mesh combined with a digit mesh, no
checkpoint under a limb mesh.

One world serves the file (module fixture); the ranks run
tests/torch_limb_worker.py and exchange numpy arrays with the parent."""

import numpy as np
import pytest
import torch

from ace_tpu.parallel.mesh import make_mesh as ace_make_mesh
from ace_tpu_torch.ckks.keygen import switch_key_nbytes
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops
from ace_tpu_torch.parallel.mesh import DP_LIMB, file_rendezvous, run_world
from ace_tpu_torch.runtime.context import FheContext

from tests import torch_limb_worker as W
from tests.torch_port_util import one_thread

SHAPES = [(1, 4), (2, 2)]
KW = dict(degree=1 << 10, num_q=8, first_mod_size=60, scaling_mod_size=56,
          hamming_weight=16, num_q_parts=3)
SEED = 5
L = 7  # the layout's limbs: 7 rows split 2/2/2/1 over 4 limb ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    data = np.arange(L * 8, dtype=np.int64).reshape(L, 8)
    msg = np.linspace(-1, 1, KW["degree"] // 2)
    calls = [("layouts", (SHAPES, data)),
             ("own_context_keys", (KW, SEED)),
             ("own_context_roundtrip", (KW, SEED, msg)),
             ("refuses_checkpoint", (KW, str(tmp_path_factory.mktemp("ck")
                                            / "m.npz")))]
    with file_rendezvous(str(tmp_path_factory.mktemp("rdv"))) as rdv, \
            one_thread():
        ranks = run_world(W.jobs, 1, 4, "gloo", "cpu", rdv, (calls,),
                          axes=DP_LIMB)
    return {"ranks": ranks, "data": data, "msg": msg}


@pytest.mark.parametrize("j", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
def test_mesh_layout_matches_ace_tpu(world, j):
    """rank = dp * n_limb + limb, the device of ace_tpu's make_mesh at
    [dp, limb]; the limb group is the rank's dp row, the dp group its
    limb column."""
    n_dp, n_limb = SHAPES[j]
    ace = ace_make_mesh(n_dp, n_limb)
    assert ace.axis_names == ("dp", "limb")
    for r, rank in enumerate(world["ranks"]):
        got = rank[0][j]
        assert got["rank"] == r
        assert ace.devices[got["dp"], got["limb"]].id == r
        assert got["shape"] == {"dp": n_dp, "limb": n_limb}
        assert got["groups"] == {
            "limb": [got["dp"] * n_limb + i for i in range(n_limb)],
            "dp": [i * n_limb + got["limb"] for i in range(n_dp)]}


@pytest.mark.parametrize("j", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
def test_put_limb_gives_the_owned_rows(world, j):
    """put_limb and shard_poly give limb g to limb rank g mod n_limb, in
    ascending order; batched, the dp row's slice of the batch too;
    replicated gives everything."""
    n_dp, n_limb = SHAPES[j]
    data = world["data"]
    for rank in world["ranks"]:
        got = rank[0][j]
        own = [g for g in range(L) if g % n_limb == got["limb"]]
        np.testing.assert_array_equal(got["put"], data[own])
        np.testing.assert_array_equal(got["shard"], data[own])
        np.testing.assert_array_equal(got["batched"],
                                      (data + got["dp"])[None][:, own])
        np.testing.assert_array_equal(got["replicated"], data)


@pytest.mark.parametrize("j", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
def test_ownership_holds_across_levels(world, j):
    """Each level's limbs are a prefix of the rank's rows, of length
    q_rows(level): a rescale or a level drop moves no data."""
    n_dp, n_limb = SHAPES[j]
    for rank in world["ranks"]:
        got = rank[0][j]
        for lv in range(L + 1):
            k = got["prefix"][lv]
            assert k == len([g for g in range(lv)
                             if g % n_limb == got["limb"]])
            np.testing.assert_array_equal(got["put_prefix"][lv],
                                          got["put"][:k])


def test_key_bytes_per_rank_sum_to_the_key(world):
    """Each rank holds its own rows of the relinearization key only:
    ceil or floor of (L+K)/4 rows, the bytes summing to
    switch_key_nbytes over the limb ranks."""
    ranks = [r[1] for r in world["ranks"]]
    total = ranks[0]["total"]
    lk = KW["num_q"] + CkksParams(**KW, device="cpu").crt.num_p
    assert sum(r["resident"] for r in ranks) == total
    for limb, r in enumerate(ranks):
        rows = len(range(limb, lk, 4))
        assert r["rows"] == rows
        assert r["resident"] * lk == total * rows
        assert r["key_memory"] == r["resident"]
    assert ranks[0]["rows"] == -(-lk // 4)


def test_sharded_keys_equal_the_unsharded_keys(world):
    """Every rank draws every stream from the seed and keeps its rows:
    gathered, the sharded secret, public and relinearization keys equal
    the unsharded context's of the same seed, on every rank."""
    with one_thread():
        ctx = FheContext(CkksParams(**KW, device="cpu"), seed=SEED)
    kg = ctx.keygen
    want_b = [modops.to_numpy(p.data) for p in kg.relin_key.b]
    want_a = [modops.to_numpy(p.data) for p in kg.relin_key.a]
    assert kg.relin_key.nbytes == switch_key_nbytes(ctx.params)
    for rank in world["ranks"]:
        got = rank[1]
        np.testing.assert_array_equal(got["sk"],
                                      modops.to_numpy(kg.sk.ntt_sk.data))
        np.testing.assert_array_equal(got["pk_b"],
                                      modops.to_numpy(kg.pk.b.data))
        for g, w in zip(got["relin_b"] + got["relin_a"], want_b + want_a):
            np.testing.assert_array_equal(g, w)


def test_own_context_decodes_a_rotation(world):
    msg = world["msg"]
    for rank in world["ranks"]:
        assert np.allclose(rank[2], np.roll(msg, -1), atol=1e-3)


def test_checkpoint_refused_under_a_limb_mesh(world):
    for rank in world["ranks"]:
        assert rank[3] is not None and "limb-sharded" in rank[3]


def test_mesh_and_digit_mesh_do_not_combine():
    with pytest.raises(ValueError, match="not both"):
        FheContext(CkksParams(**KW, device="cpu"), mesh=object(),
                   digit_mesh=object())


def test_crt_context_defaults_to_the_card():
    """CrtContext's device=None is the card, as every entry point's:
    without one it raises instead of running on the CPU."""
    from ace_tpu_torch.poly.rns import CrtContext
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CrtContext(4, 60, 56, 64, 2)
    assert CrtContext(4, 60, 56, 64, 2, device="cpu").device.type == "cpu"


def test_empty_shard_runs_the_plain_versions():
    """A rank may own no row of a small poly (level 1 on 4 limb ranks):
    the wrappers' plain versions take [0, N] tensors."""
    from ace_tpu_torch.ops import ntt, ntt4, pallas_modops as pm
    crt = CkksParams(**KW, device="cpu").crt
    x = torch.zeros((0, KW["degree"]), dtype=torch.int64)
    q, mh, ml = crt.mod_arrays([])
    assert q.shape == (0, 1)
    assert pm.barrett_mul(x, x, q, mh, ml).shape == x.shape
    assert pm.shoup_mul(x, q, q, q).shape == x.shape
    t = crt.tables_for([])
    assert ntt4.ntt4_fwd(x, t).shape == x.shape
    assert ntt.ntt_inv(x, t).shape == x.shape
