"""Build the port's objects from numpy arrays.

Keys are the weights of this system, and they are random: `ace_tpu`
draws the uniform part of its switching keys with jax.random, which
torch cannot reproduce. To run both packages on the same keys and the
same ciphertexts, the caller extracts the arrays from the other side
(residues as uint64 arrays [limbs, N], e.g. `np.asarray(poly.data)`)
and builds the port's objects here. Nothing here imports the other
package; every function takes plain numpy arrays and Python numbers.
"""

from __future__ import annotations

import copy

import numpy as np

from ace_tpu_torch.ckks.cipher import Ciphertext
from ace_tpu_torch.ckks.encoder import Plaintext
from ace_tpu_torch.ckks.keygen import (KeyGenerator, PublicKey, SecretKey,
                                       SwitchKey)
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops
from ace_tpu_torch.poly.poly import RnsPoly


def poly(data, num_q: int, num_p: int, is_ntt: bool, device) -> RnsPoly:
    """Residues [num_q + num_p, N] (uint64) -> RnsPoly on `device`."""
    data = np.asarray(data, dtype=np.uint64)
    assert data.shape[0] == num_q + num_p, (data.shape, num_q, num_p)
    return RnsPoly(modops.to_torch(data, device), num_q, num_p, is_ntt)


def to_numpy(p: RnsPoly) -> np.ndarray:
    """RnsPoly -> uint64 residues [limbs, N] on the host."""
    return modops.to_numpy(p.data)


def switch_key(b_digits, a_digits, params: CkksParams) -> SwitchKey:
    """One (b, a) pair per digit, each [num_q + num_p, N] in NTT form."""
    crt = params.crt

    def full(d):
        return poly(d, crt.num_q, crt.num_p, True, params.device)
    return SwitchKey([full(d) for d in b_digits], [full(d) for d in a_digits])


def keygen(params: CkksParams, sk_coeffs, sk_ntt, pk_b, pk_a,
           relin: tuple, rot_keys: dict | None = None,
           rng=None) -> KeyGenerator:
    """A KeyGenerator holding the given keys instead of sampling them.

    sk_coeffs: signed ternary [N]; sk_ntt: [num_q + num_p, N] NTT form;
    pk_b, pk_a: [num_q, N]; relin: ([b digits], [a digits]);
    rot_keys: {rotation: (auto_idx, [b digits], [a digits])}, held by
    auto_idx; an entry with auto_idx 2N-1 is the conjugation key.
    rng: host generator for encryption noise (and for any rotation key
    not given, which is then generated)."""
    crt = params.crt
    kg = KeyGenerator.__new__(KeyGenerator)
    kg.params = params
    kg.crt = crt
    kg.device = params.device
    kg.rng = rng
    kg.max_rot_keys = 0
    kg.sk = SecretKey(np.asarray(sk_coeffs, dtype=np.int64),
                      poly(sk_ntt, crt.num_q, crt.num_p, True,
                           params.device))
    kg.pk = PublicKey(poly(pk_b, crt.num_q, 0, True, params.device),
                      poly(pk_a, crt.num_q, 0, True, params.device))
    kg.relin_key = switch_key(*relin, params)
    kg._rot_keys = {}
    for _, (auto_idx, b, a) in (rot_keys or {}).items():
        kg._rot_keys[int(auto_idx)] = switch_key(b, a, params)
    return kg


def ciphertext(c0, c1, scaling_factor: float, sf_degree: int, slots: int,
               device, num_p: int = 0) -> Ciphertext:
    """Ciphertext from its two NTT-form components [level + num_p, N]."""
    level = np.asarray(c0).shape[0] - num_p
    return Ciphertext(poly(c0, level, num_p, True, device),
                      poly(c1, level, num_p, True, device),
                      float(scaling_factor), int(sf_degree), int(slots))


def plaintext(data, scaling_factor: float, sf_degree: int, slots: int,
              device, num_p: int = 0) -> Plaintext:
    """Plaintext from its NTT-form residues [level + num_p, N]."""
    level = np.asarray(data).shape[0] - num_p
    return Plaintext(poly(data, level, num_p, True, device),
                     float(scaling_factor), int(sf_degree), int(slots))


def nngraph(ops: list, weights: dict, input_name: str, input_shape,
            output_name: str):
    """The port's NNGraph from plain data: `ops` as dicts of NNOp fields
    (op_type, name, inputs, outputs, attrs, in_shape, out_shape) and the
    weights as numpy arrays."""
    from ace_tpu_torch.compiler.onnx_front import NNGraph, NNOp
    return NNGraph([NNOp(**copy.deepcopy(dict(op))) for op in ops],
                   {k: np.array(v) for k, v in weights.items()},
                   input_name, tuple(input_shape), output_name)
