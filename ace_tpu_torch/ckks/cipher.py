"""Ciphertext containers (tensors plus static scale metadata)."""

from __future__ import annotations

import dataclasses

from ace_tpu_torch.poly.poly import RnsPoly


@dataclasses.dataclass
class Ciphertext:
    c0: RnsPoly
    c1: RnsPoly
    scaling_factor: float
    sf_degree: int
    slots: int

    @property
    def level(self) -> int:
        return self.c0.num_q

    @property
    def num_p(self) -> int:
        return self.c0.num_p


@dataclasses.dataclass
class Ciphertext3:
    """Degree-2 ciphertext (c0, c1, c2) before relinearization."""
    c0: RnsPoly
    c1: RnsPoly
    c2: RnsPoly
    scaling_factor: float
    sf_degree: int
    slots: int

    @property
    def level(self) -> int:
        return self.c0.num_q
