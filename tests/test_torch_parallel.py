"""PyTorch port: the process mesh and the slot-sharded NTT on a gloo
world of spawned CPU ranks (ace_tpu_torch/parallel/mesh.py,
sharded_ntt.py), bit for bit against ace_tpu.parallel.sharded_ntt on
conftest's 8-device virtual mesh and against the single-device NTTs of
both packages, at tests/test_sharded_ntt.py's (n, d) pairs with d <= 4.

One 4-rank world serves the whole file (module fixture); the ranks run
tests/torch_spmd_worker.py and exchange numpy arrays with the parent."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ace_tpu.ops import ntt
from ace_tpu.parallel import sharded_ntt as S
from ace_tpu.utils import number_theory as nt
from ace_tpu_torch.ops import ntt as TN
from ace_tpu_torch.parallel import sharded_ntt as TS
from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world

from tests import torch_spmd_worker as W
from tests.torch_port_util import one_thread, to_np, to_t

PAIRS = [(1024, 4), (8192, 2), (4096, 4)]
SHAPES = [(2, 2), (1, 4), (4, 1)]


def _inputs(n):
    primes = nt.generate_q_primes(3, 60, 56, n)
    rng = np.random.default_rng(6 + n)
    return primes, np.stack([rng.integers(0, q, n, dtype=np.uint64)
                             for q in primes])


# ace_tpu's shard_map NTT traces and compiles anew on every call (16-27 s
# each here), so it is run at one pair; at every pair the port is held
# against ace_tpu's single-device NTT, which tests/test_sharded_ntt.py
# holds equal to ace_tpu's sharded one.
ACE_SHARDED = (1024, 4)


def _ace_sharded(n, d):
    """ace_tpu's own sharded forward and inverse on d virtual devices."""
    primes, x = _inputs(n)
    mesh = Mesh(np.array(jax.devices()[:d]), ("limb",))
    ts = S.make_sharded_ntt_tables(primes, n)
    return (np.asarray(S.sharded_ntt_fwd(x, ts, mesh)),
            np.asarray(S.sharded_ntt_inv(x, ts, mesh)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results for every case of the file, and ace_tpu's
    sharded NTT at ACE_SHARDED (computed while the world runs)."""
    cases = [(n, d, *_inputs(n)) for n, d in PAIRS]
    calls = [("mesh_layouts", (SHAPES,)), ("sharded_ntts", (cases,))]
    with ThreadPoolExecutor(1) as pool, one_thread():
        ace = pool.submit(_ace_sharded, *ACE_SHARDED)
        with file_rendezvous(str(tmp_path_factory.mktemp("rdv"))) as rdv:
            ranks = run_world(W.jobs, 2, 2, "gloo", "cpu", rdv, (calls,))
        return {"ranks": ranks, "ace_sharded": ace.result(),
                "cases": cases}


@pytest.mark.parametrize("n", sorted({n for n, _ in PAIRS}))
def test_tables_equal_ace_tpu(n):
    primes = nt.generate_q_primes(3, 60, 56, n)
    want = S.make_sharded_ntt_tables(primes, n)
    got = TS.make_sharded_ntt_tables(primes, n, "cpu")
    for name in TS.ShardedNttTables._fields:
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("i", range(len(PAIRS)),
                         ids=[f"{n}-{d}" for n, d in PAIRS])
def test_sharded_ntt_bit_exact(world, i):
    """On every rank: forward and inverse equal ace_tpu's single-device
    transforms (and its sharded ones at ACE_SHARDED) and the port's plain
    ladders."""
    n, d, primes, x = world["cases"][i]
    t1 = ntt.make_ntt_tables(primes, n, four_step=False)
    want_fwd = np.asarray(ntt.ntt_fwd(x, t1))
    want_inv = np.asarray(ntt.ntt_inv(x, t1))
    if (n, d) == ACE_SHARDED:
        np.testing.assert_array_equal(world["ace_sharded"][0], want_fwd)
        np.testing.assert_array_equal(world["ace_sharded"][1], want_inv)
    tt = TN.make_ntt_tables(primes, n, device="cpu")
    np.testing.assert_array_equal(to_np(TN.ntt_fwd_plain(to_t(x), tt)),
                                  want_fwd)
    np.testing.assert_array_equal(to_np(TN.ntt_inv_plain(to_t(x), tt)),
                                  want_inv)
    for rank in world["ranks"]:
        got = rank[1][i]
        np.testing.assert_array_equal(got["fwd"], want_fwd)
        np.testing.assert_array_equal(got["inv"], want_inv)


@pytest.mark.parametrize("i", range(len(PAIRS)),
                         ids=[f"{n}-{d}" for n, d in PAIRS])
def test_sharded_round_trip(world, i):
    x = world["cases"][i][3]
    for rank in world["ranks"]:
        np.testing.assert_array_equal(rank[1][i]["back"], x)


@pytest.mark.parametrize("j", range(len(SHAPES)),
                         ids=[f"{a}x{b}" for a, b in SHAPES])
def test_mesh_group_layout(world, j):
    """rank = digit * s + slot, as ace_tpu's np.reshape(devices, (D, s));
    the slot group is the rank's digit row, the digit group its slot
    column, each in rank order."""
    digits, slots = SHAPES[j]
    for r, rank in enumerate(world["ranks"]):
        got = rank[0][j]
        d, k = divmod(r, slots)
        assert (got["rank"], got["digit"], got["slot"]) == (r, d, k)
        assert got["shape"] == {"digit": digits, "slot": slots}
        assert got["groups"] == {
            "slot": [d * slots + i for i in range(slots)],
            "digit": [i * slots + k for i in range(digits)]}


def test_failing_rank_fails_the_world(tmp_path):
    with file_rendezvous(str(tmp_path)) as rdv:
        with pytest.raises(RuntimeError,
                           match=r"rank 1 of 2 failed(.|\n)*on purpose"):
            run_world(W.failing_rank, 1, 2, "gloo", "cpu", rdv, (1,))


def test_world_refuses_a_missing_card(tmp_path):
    """The backend and device are the caller's: no fallback to the CPU
    when the card is missing, and no two NCCL ranks on one card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_world(W.failing_rank, 1, 1, "gloo", "cuda:0", "file:///x", (0,))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_world(W.failing_rank, 1, 1, "nccl", "cuda", "file:///x", (0,))
    with pytest.raises(ValueError, match="backend"):
        run_world(W.failing_rank, 1, 1, "mpi", "cpu", "file:///x", (0,))
