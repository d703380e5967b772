"""Runtime context: one-stop setup for encrypted inference.

The FheContext of `ace_tpu.runtime.context` (the reference's rtlib
context.c Prepare_context:29-86 plus the io_api client/server split):
the *client* holds the secret key and does encode/encrypt/decrypt on the
host; the *server* holds only evaluation keys and runs the encrypted
graph on the device, bootstrapping included. `mesh` limb-shards keys,
plaintexts and ciphertexts over a ('dp', 'limb') process mesh
(CrtContext.shard); `digit_mesh` routes the key switches through the
SPMD evaluator (parallel/spmd_eval.py).
"""

from __future__ import annotations

import numpy as np

from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.runtime.timing import TIMING


class FheContext:
    """Prepare params -> keys -> encoder/evaluator."""

    def __init__(self, params: CkksParams = None, *, scheme_info=None,
                 seed: int = 0, max_rot_keys: int = 0,
                 rot_key_budget_bytes: int = 0, device=None, mesh=None,
                 digit_mesh=None):
        """device: None runs on the card (and raises without one);
        "cpu" runs the plain versions. Ignored when `params` is given
        (its CRT context fixes the device).
        mesh: this rank's parallel.mesh.LimbMesh (make_mesh); the CRT
        context is sharded over its limb axis before any key is made,
        so every rank holds and computes its own limbs of every key,
        plaintext and ciphertext (the counterpart of ace_tpu's put_limb
        residency). Every rank of the world runs the same program on the
        same seed; the dp rows hold the same keys.
        digit_mesh: this rank's parallel.mesh.DigitSlotMesh; rotate, mul
        and relinearize then go through the SPMD evaluator
        (parallel/spmd_eval.py) with per-digit key residency. It does
        not combine with `mesh` (ace_tpu never runs the two together)."""
        from ace_tpu_torch.ckks.encoder import Encoder
        from ace_tpu_torch.ckks.keygen import KeyGenerator
        from ace_tpu_torch.ckks.evaluator import Evaluator

        if mesh is not None and digit_mesh is not None:
            raise ValueError("FheContext takes a limb mesh or a digit mesh, "
                             "not both")
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
        self.mesh = mesh
        if mesh is not None:
            params.crt.shard(mesh)
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
            if digit_mesh is not None:
                from ace_tpu_torch.parallel.spmd_eval import SpmdEvaluator
                self.evaluator = SpmdEvaluator(params, self.keygen,
                                               self.encoder, digit_mesh)
            else:
                self.evaluator = Evaluator(params, self.keygen,
                                           self.encoder)
        self._bts = {}  # slot count -> BootstrapContext
        self.pt_mgr = None
        self.manifest = None
        self._io_inputs: dict[str, object] = {}
        self._io_outputs: dict[str, object] = {}

    def hbm_plan(self) -> str:
        """Static device-memory budget report (the analog of the
        reference's key/weight memory report, rtlib context.c:100-116);
        under a limb mesh, this rank's share (its rows of each key and
        workspace)."""
        from ace_tpu_torch.ckks.keygen import switch_key_nbytes
        p = self.params
        n = p.degree
        L = p.crt.num_q
        K = p.crt.num_p
        lk = len(p.crt.local(range(L + K)))
        key_b = switch_key_nbytes(p) * lk // (L + K)
        n_keys = self.keygen.max_rot_keys or 0
        keys = n_keys * key_b
        msg_budget = self.encoder._msg_cache_budget
        pt_budget = self.encoder._pt_cache_budget
        bundle = self.evaluator.max_bundle_msg
        # peak bundle workspace: R keyswitch exts (2 polys, L+K limbs)
        # + R key digit planes + one group's MAC transients
        row = lk * n * 8
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

    @classmethod
    def from_manifest(cls, path: str, **kw) -> "FheContext":
        """Rebuild a runtime context from a compile-driver manifest
        (the analog of the generated Get_context_params consumed by
        Prepare_context — eg_fhertlib_add.inc:15-24, context.c:29-86).

        Restores the scheme parameters, opens the weight file if the
        manifest names one (a missing one raises FileNotFoundError, where
        ace_tpu's skips it), and pre-warms the rotation-key LRU with the
        manifest's rotation inventory (up to the LRU capacity), as
        ace_tpu's does. kw go to the constructor (device, max_rot_keys,
        ...)."""
        import json
        import os
        from ace_tpu_torch.compiler.scheme_info import SchemeInfo
        with open(path) as f:
            m = json.load(f)
        s = dict(m["scheme"])
        s["rotate_indices"] = tuple(s.get("rotate_indices", ()))
        wf = m.get("weights_file")
        if wf:
            if not os.path.isabs(wf):
                wf = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  wf)
            if not os.path.exists(wf):
                raise FileNotFoundError(f"manifest {path} names the weight "
                                        f"file {wf}, which does not exist")
        ctx = cls(scheme_info=SchemeInfo(**s), **kw)
        ctx.manifest = m
        if wf:
            ctx.open_weight_file(wf)
        rots = m.get("rotate_indices", [])
        cap = ctx.keygen.max_rot_keys or len(rots)
        for r in rots[:cap]:
            if r:
                ctx.keygen.rot_key(int(r))
        return ctx

    # -- bootstrap precompute (context.c:162-185) -----------------------

    def bootstrap_precom(self, slots: int = 0):
        from ace_tpu_torch.ckks.bootstrap import BootstrapContext
        slots = slots or self.params.degree // 2
        if slots not in self._bts:
            with TIMING.tm("RTM_BS_SETUP"):
                self._bts[slots] = BootstrapContext(self.evaluator, slots)
        return self._bts[slots]

    def bootstrap(self, ct):
        """Bootstrap to the top of the chain with lazy per-slot-count
        precompute (cipher_eval.c:366-380)."""
        with TIMING.tm("RTM_BOOTSTRAP"):
            return self.bootstrap_precom(ct.slots).bootstrap(ct)

    # -- weight manager ---------------------------------------------------

    def open_weight_file(self, path: str):
        from ace_tpu_torch.runtime.rt_data import RtDataReader, PtManager
        self.pt_mgr = PtManager(RtDataReader(path), self.encoder,
                                path=path)
        return self.pt_mgr

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

    def get_output_data(self, name: str):
        """The ciphertext posted under `name` (before Handle_output)."""
        return self._io_outputs[name]

    def handle_output(self, name: str, length: int = 0) -> np.ndarray:
        """Client-side decrypt+decode (Handle_output). Residual limbs
        above the floor are dropped first (exact mod-switch: message +
        noise << the remaining modulus), which keeps the exact-CRT
        decode cheap at any output level."""
        ev = self.evaluator
        pt = ev.decrypt(ev.mod_switch_to_decode_floor(self._io_outputs[name]))
        return self.encoder.decode(pt, length).real

    # -- reporting (Finalize_context) -------------------------------------

    def key_memory_bytes(self) -> int:
        """Total evaluation-key device memory (context.c:100-107)."""
        return sum(p.data.numel() * p.data.element_size()
                   for key in self.keygen.all_keys()
                   for p in (*key.b, *key.a))

    def finalize(self) -> str:
        with TIMING.tm("RTM_FINALIZE_CONTEXT"):
            report = ["[RT_STAT] key memory: %.1f MB"
                      % (self.key_memory_bytes() / 2**20)]
            report.append(TIMING.report())
        return "\n".join(report)
