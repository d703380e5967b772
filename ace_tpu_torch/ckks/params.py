"""CKKS parameter sets.

Mirrors the reference CKKS_PARAMETER policy (fhe-cmplr/rtlib/ant/src/util/
ckks_parameters.c): scaling factor = 2^scaling_mod_size, num_q_parts
defaults per fhe_std_parms.c:327-334, CRT context built with the same
prime chains.
"""

from __future__ import annotations

import dataclasses

from ace_tpu_torch.poly.rns import CrtContext


def default_num_q_parts(mult_depth: int) -> int:
    """fhe_std_parms.c:327-334 (Get_default_num_q_parts)."""
    if mult_depth > 3:
        return 3
    if mult_depth == 0:
        return 1
    return 2


@dataclasses.dataclass
class CkksParams:
    degree: int
    num_q: int
    first_mod_size: int = 60
    scaling_mod_size: int = 56
    hamming_weight: int = 0          # 0 = uniform ternary secret
    num_q_parts: int = 0             # 0 = policy default
    crt: CrtContext = None
    device: object = None            # tables' device; None = the card

    def __post_init__(self):
        if self.num_q_parts == 0:
            self.num_q_parts = default_num_q_parts(self.num_q - 1)
        if self.crt is None:
            from ace_tpu_torch import resolve_device
            self.crt = CrtContext(self.num_q, self.first_mod_size,
                                  self.scaling_mod_size, self.degree,
                                  self.num_q_parts,
                                  resolve_device(self.device))
        self.device = self.crt.device
        self.scaling_factor = float(1 << self.scaling_mod_size)

    @property
    def mult_depth(self) -> int:
        return self.num_q - 1

    @property
    def slots(self) -> int:
        return self.degree // 2
