"""PyTorch port: op programs captured as CUDA graphs on the card
(utils/liftgraph.py through ckks/evaluator.py, and split at the
collectives of the meshes, parallel/). Each test needs a CUDA
card and skips without one; the CPU tests of the program layer are in
tests/test_torch_programs.py. This file imports neither jax nor ace_tpu,
so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_graphs.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from ace_tpu_torch import ops
from ace_tpu_torch.ckks.encoder import Encoder
from ace_tpu_torch.ckks.evaluator import Evaluator
from ace_tpu_torch.ckks.keygen import KeyGenerator
from ace_tpu_torch.ckks.params import CkksParams

KW = dict(degree=1 << 12, num_q=8, first_mod_size=60, scaling_mod_size=50,
          num_q_parts=3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_replays_equal_the_eager_path():
    """rotate, mul, rescale and the conv bundle through programs (call 1
    eager, call 2 captured, call 3 replayed) on fresh ciphertexts, each
    equal word for word to the eager evaluator's on the same keys, with
    the same kernel-counter growth."""
    _card()
    params = CkksParams(**KW, device="cuda")
    kg = KeyGenerator(params, np.random.default_rng(1))
    for r in (1, 2, 5):  # made first: key generation launches kernels too
        kg.rot_key(r)
    enc = Encoder(params)
    prog = Evaluator(params, kg, enc)
    eager = Evaluator(params, kg, enc, programs=False)
    rng = np.random.default_rng(2)
    n = KW["degree"]
    msgs = torch.as_tensor(rng.integers(-(1 << 30), 1 << 30, (2, 3, n)),
                           device="cuda")

    def ops_of(ev, ct):
        return [ev.rotate(ct, 5), ev.rescale(ev.mul(ct, ct)),
                *ev.rot_mac_groups_msgs_jit(ct, [0, 1, 2], msgs)]

    for _ in range(3):
        ct = prog.encrypt(enc.encode(rng.uniform(-1, 1, n // 2)
                                     .astype(np.complex128)))
        got = []
        for ev in (prog, eager):
            ops.reset_counters()
            outs = ops_of(ev, ct)
            torch.cuda.synchronize()
            got.append((outs, ops.counter_state()))
        (a, ca), (b, cb) = got
        assert ca == cb
        for x, y in zip(a, b):
            assert torch.equal(x.c0.data, y.c0.data)
            assert torch.equal(x.c1.data, y.c1.data)
    st = prog.program_stats()
    assert st["captures"] == 4 and st["replays"] == 8  # calls 2 and 3
    assert st["pool_bytes"] > 0


@pytest.mark.gpu
def test_mesh_programs_split_at_collectives(tmp_path):
    """A 2-rank gloo world sharing the card (tests/torch_mesh_program_worker.py
    card_programs): SpmdKeySwitch.rotate on a 1 x 2 digit x slot mesh and
    Evaluator.rescale on a 1 x 2 limb mesh, each through its program
    (eager, captured, replayed) and eagerly on fresh ciphertexts, word for
    word equal with equal kernel-counter growth; the programs are split
    at their collectives (the rotate's 12 all_to_all and its slot
    gather, its one-rank digit sum skipped; the rescale's two
    broadcasts)."""
    _card()
    from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world
    from tests import torch_mesh_program_worker as W
    kw = dict(KW, num_q=6, num_q_parts=2)
    with file_rendezvous(str(tmp_path)) as rdv:
        ranks = run_world(W.card_programs, 1, 2, "gloo", "cuda:0", rdv,
                          (kw, 3))
    for r in ranks:
        assert r["spmd_segments"] == 14 and r["spmd_switches"] == 3
        assert r["spmd"]["captures"] == 1 and r["spmd"]["replays"] == 2
        assert r["limb_segments"]["rs"] == [3]
        assert r["limb"]["captures"] == 1 and r["limb"]["replays"] == 2
