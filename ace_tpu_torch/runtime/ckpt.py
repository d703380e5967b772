"""Op-stream checkpoint/resume for long encrypted inferences.

The checkpoint of `ace_tpu.runtime.ckpt`, in the same file format, so a
file written by either package resumes in the other. The CKKS level
trajectory is static, so resuming at op K with the saved ciphertexts is
exact.

Format: one .npz per checkpoint holding, per live value, the raw limb
planes of (c0, c1) as uint64 arrays (the port's int64 residues viewed as
uint64) plus a JSON `__meta__` entry with the scale metadata and the
next op index. Atomic via write-to-temp + rename.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ace_tpu_torch.ckks.cipher import Ciphertext
from ace_tpu_torch.ops import modops
from ace_tpu_torch.poly.poly import RnsPoly


def save(path: str, env: dict, next_op: int) -> None:
    arrays = {}
    meta = {"next_op": next_op, "values": {}}
    for name, ct in env.items():
        if not isinstance(ct, Ciphertext):
            raise TypeError(
                f"checkpoint supports plain Ciphertext envs only "
                f"(got {type(ct).__name__} for {name!r})")
        i = len(meta["values"])
        arrays[f"c0_{i}"] = modops.to_numpy(ct.c0.data)
        arrays[f"c1_{i}"] = modops.to_numpy(ct.c1.data)
        meta["values"][name] = {
            "i": i,
            "num_q": ct.c0.num_q, "num_p": ct.c0.num_p,
            "is_ntt": bool(ct.c0.is_ntt),
            "scaling_factor": float(ct.scaling_factor),
            "sf_degree": int(ct.sf_degree), "slots": int(ct.slots),
        }
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load(path: str, device) -> tuple[dict, int]:
    """Returns (env, next_op), the ciphertexts placed on `device`."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        env = {}
        for name, v in meta["values"].items():
            i = v["i"]
            c0, c1 = (RnsPoly(modops.to_torch(z[f"{c}_{i}"], device),
                              v["num_q"], v["num_p"], v["is_ntt"])
                      for c in ("c0", "c1"))
            env[name] = Ciphertext(c0, c1, v["scaling_factor"],
                                   v["sf_degree"], v["slots"])
    return env, meta["next_op"]
