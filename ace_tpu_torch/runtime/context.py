"""Runtime context: one-stop setup for encrypted inference.

The FheContext of `ace_tpu.runtime.context` (the reference's rtlib
context.c Prepare_context:29-86 plus the io_api client/server split):
the *client* holds the secret key and does encode/encrypt/decrypt on the
host; the *server* holds only evaluation keys and runs the encrypted
graph on the device. Single device: the JAX package's mesh options and
its SPMD evaluator have no counterpart in this slice.
"""

from __future__ import annotations

import numpy as np

from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.runtime.timing import TIMING


class FheContext:
    """Prepare params -> keys -> encoder/evaluator on one device."""

    def __init__(self, params: CkksParams = None, *, scheme_info=None,
                 seed: int = 0, max_rot_keys: int = 0,
                 rot_key_budget_bytes: int = 0, device=None):
        """device: None runs on the card (and raises without one);
        "cpu" runs the plain versions. Ignored when `params` is given
        (its CRT context fixes the device)."""
        from ace_tpu_torch.ckks.encoder import Encoder
        from ace_tpu_torch.ckks.keygen import KeyGenerator
        from ace_tpu_torch.ckks.evaluator import Evaluator

        if params is None:
            si = scheme_info
            params = CkksParams(
                degree=si.poly_degree, num_q=si.mul_level + 1,
                first_mod_size=si.first_mod_size,
                scaling_mod_size=si.scaling_mod_size,
                hamming_weight=si.hamming_weight,
                num_q_parts=si.q_part_num, device=device)
        self.params = params
        self.device = params.device
        if rot_key_budget_bytes and not max_rot_keys:
            # size the rotation-key LRU from the per-key bytes of the key
            # structure (context.c:100-107)
            from ace_tpu_torch.ckks.keygen import switch_key_nbytes
            max_rot_keys = max(
                16, rot_key_budget_bytes // switch_key_nbytes(params))
        with TIMING.tm("RTM_PREPARE_CONTEXT"):
            self.encoder = Encoder(params)
            from ace_tpu_torch.utils.csprng import Blake2Csprng
            self.keygen = KeyGenerator(params, Blake2Csprng(seed),
                                       max_rot_keys=max_rot_keys)
            self.evaluator = Evaluator(params, self.keygen, self.encoder)
        self._io_inputs: dict[str, object] = {}
        self._io_outputs: dict[str, object] = {}

    def hbm_plan(self) -> str:
        """Static device-memory budget report (the analog of the
        reference's key/weight memory report, rtlib context.c:100-116)."""
        from ace_tpu_torch.ckks.keygen import switch_key_nbytes
        p = self.params
        n = p.degree
        L = p.crt.num_q
        K = p.crt.num_p
        key_b = switch_key_nbytes(p)
        n_keys = self.keygen.max_rot_keys or 0
        keys = n_keys * key_b
        msg_budget = self.encoder._msg_cache_budget
        pt_budget = self.encoder._pt_cache_budget
        bundle = self.evaluator.max_bundle_msg
        # peak bundle workspace: R keyswitch exts (2 polys, L+K limbs)
        # + R key digit planes + one group's MAC transients
        row = (L + K) * n * 8
        exts = bundle * 2 * row
        kdig = bundle * 2 * p.crt.num_decomp(L) * row
        work = exts + kdig + 4 * row
        total = keys + msg_budget + pt_budget + work
        return ("[RT_STAT] device-memory plan: rot-keys %d x %.0f MB = "
                "%.2f GB, msg-cache %.1f GB, pt-cache %.1f GB, bundle "
                "workspace %.2f GB (R<=%d at L=%d) -> planned peak %.2f GB "
                "(+ live ciphertexts)"
                % (n_keys, key_b / 2**20, keys / 2**30,
                   msg_budget / 2**30, pt_budget / 2**30,
                   work / 2**30, bundle, L, total / 2**30))

    # -- client side (io_api): encode/encrypt/decrypt --------------------

    def prepare_input(self, tensor: np.ndarray, name: str,
                      level: int = 0):
        """Encode+encrypt an input tensor and post it to the server-side
        input queue (Prepare_input + Io_set_input). `level` 0 encrypts
        at the top of the chain."""
        with TIMING.tm("RTM_ENCODE_ARRAY"):
            flat = np.asarray(tensor, dtype=np.float64).reshape(-1)
            slots = self.params.degree // 2
            msg = np.zeros(slots, dtype=np.complex128)
            msg[:flat.size] = flat
            pt = self.encoder.encode(msg, level=level)
        ct = self.evaluator.encrypt(pt)
        self._io_inputs[name] = ct
        return ct

    def get_input_data(self, name: str):
        """Server-side fetch (Get_input_data)."""
        return self._io_inputs[name]

    def set_output_data(self, name: str, ct):
        """Server-side post (Set_output_data)."""
        self._io_outputs[name] = ct

    def handle_output(self, name: str, length: int = 0) -> np.ndarray:
        """Client-side decrypt+decode (Handle_output). Residual limbs
        above the floor are dropped first (exact mod-switch: message +
        noise << the remaining modulus), which keeps the exact-CRT
        decode cheap at any output level."""
        ct = self._io_outputs[name]
        floor = 3 if ct.sf_degree <= 1 else 2 + 2 * ct.sf_degree
        while ct.level > floor:
            ct = self.evaluator.mod_switch(ct)
        pt = self.evaluator.decrypt(ct)
        return self.encoder.decode(pt, length).real
