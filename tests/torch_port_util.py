"""Helpers for the tests that hold the PyTorch port against `ace_tpu`.

Arrays cross between the packages as numpy: `ace_tpu` objects give
their residues with np.asarray(poly.data), and ace_tpu_torch.interop
builds the port's objects from them.
"""

import contextlib

import numpy as np
import torch

from ace_tpu_torch import interop
from ace_tpu_torch.ops import modops as TM

CPU = torch.device("cpu")


def arr(poly) -> np.ndarray:
    """Residues of an ace_tpu RnsPoly as uint64 numpy."""
    return np.asarray(poly.data)


def to_t(a) -> torch.Tensor:
    """uint64 numpy (or a jax array) -> int64 CPU tensor, same bits."""
    return TM.to_torch(np.asarray(a, dtype=np.uint64), CPU)


def to_np(t: torch.Tensor) -> np.ndarray:
    return TM.to_numpy(t)


def port_poly(poly):
    """ace_tpu RnsPoly -> port RnsPoly on the CPU."""
    return interop.poly(arr(poly), poly.num_q, poly.num_p, poly.is_ntt, CPU)


def port_ct(ct):
    """ace_tpu Ciphertext -> port Ciphertext on the CPU."""
    return interop.ciphertext(arr(ct.c0), arr(ct.c1), ct.scaling_factor,
                              ct.sf_degree, ct.slots, CPU,
                              num_p=ct.c0.num_p)


def key_arrays(kg) -> tuple:
    """The keys of ace_tpu KeyGenerator kg (secret, public, relin and
    every rotation key it holds) as interop.keygen's numpy arguments."""
    rot = {ai: (ai, [arr(p) for p in key.b], [arr(p) for p in key.a])
           for ai, key in kg._rot_keys.items()}
    return (kg.sk.coeffs, arr(kg.sk.ntt_sk), arr(kg.pk.b), arr(kg.pk.a),
            ([arr(p) for p in kg.relin_key.b],
             [arr(p) for p in kg.relin_key.a]), rot)


def port_keygen(params_t, kg, rng=None):
    """A port KeyGenerator holding the keys of ace_tpu KeyGenerator kg."""
    return interop.keygen(params_t, *key_arrays(kg), rng=rng)


def assert_poly_equal(got, want) -> None:
    """Port RnsPoly == ace_tpu RnsPoly, residue for residue."""
    assert (got.num_q, got.num_p, got.is_ntt) == \
        (want.num_q, want.num_p, want.is_ntt)
    np.testing.assert_array_equal(to_np(got.data), arr(want))


def assert_ct_equal(got, want) -> None:
    assert got.level == want.level and got.sf_degree == want.sf_degree
    assert got.scaling_factor == want.scaling_factor
    assert_poly_equal(got.c0, want.c0)
    assert_poly_equal(got.c1, want.c1)


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block. Tests that spawn worlds
    of ranks use it: with the other test workers they oversubscribe the
    host's cores, and torch's spinning intra-op threads then slow this
    process many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
