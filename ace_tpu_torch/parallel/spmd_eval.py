"""Evaluator with the digit x slot SPMD key switch in the model path.

`ace_tpu.parallel.spmd_eval` on the port: `SpmdEvaluator` is a drop-in
`Evaluator` (FheContext(digit_mesh=...)) whose rotate, mul and
relinearize, at levels where the live digit count equals the mesh's
digit axis, go through `parallel.spmd.SpmdKeySwitch`: per-digit MACs
summed over 'digit', slot-sharded 4-step NTTs with all_to_all
transposes over 'slot', and per-digit key stacks (each rank stacks
1/(D*s) of every switching key it uses; its KeyGenerator still holds
the full keys, as ace_tpu's does). Every other op, and every level
where the decomposition has another digit count, runs the single-device
code; the two paths are bit-exact, so mixing them is sound.

Op programs. With programs on (the default, as ace_tpu's inherited
jitted bundles), the SPMD key switches run SpmdKeySwitch's "rot" and
"relin" programs, split at their collectives, and every other op the
single-device programs, which have none; all of them share the
evaluator's one GraphPool, since they replay one at a time.

Every rank of the mesh runs the same program on the same ciphertexts
(ace_tpu's arrays are global), so every rank must hold the same keys:
the same seed, or the same injected keys.
"""

from __future__ import annotations

from ace_tpu_torch.ckks.evaluator import Evaluator
from ace_tpu_torch.parallel.spmd import SpmdKeySwitch
from ace_tpu_torch.runtime.timing import timed


class SpmdEvaluator(Evaluator):
    def __init__(self, params, keygen, encoder, digit_mesh, **kw):
        super().__init__(params, keygen, encoder, **kw)
        self.digit_mesh = digit_mesh
        self._spmd: dict[int, SpmdKeySwitch | None] = {}

    def _ksw(self, level: int) -> SpmdKeySwitch | None:
        """The SPMD key switch for `level` if the mesh's digit axis
        matches the live q-part count there, else None (fallback)."""
        if level not in self._spmd:
            crt = self.crt
            ok = (level >= crt.per_part_size
                  and crt.num_decomp(level)
                  == self.digit_mesh.shape["digit"]
                  and self.params.degree
                  >= 2 * self.digit_mesh.shape["slot"] * 128)
            self._spmd[level] = (SpmdKeySwitch(
                self.params, level, self.digit_mesh, self.programs,
                self._graph_pool() if self.programs else None)
                if ok else None)
        return self._spmd[level]

    def program_segments(self) -> dict:
        """Evaluator.program_segments, plus "spmd rot" and "spmd relin":
        the segments of each level's SpmdKeySwitch programs."""
        out = super().program_segments()
        for k in self._spmd.values():
            for kind, p in (k._jit_cache.items() if k is not None else ()):
                if getattr(p, "segments", None) is not None:
                    out.setdefault(f"spmd {kind}", []).append(p.segments)
        return out

    @property
    def spmd_switches(self) -> int:
        """Key switches this rank took through SpmdKeySwitch."""
        return sum(k.switches for k in self._spmd.values() if k is not None)

    @timed("CKKS::rotate", keyswitch=True)
    def rotate(self, a, rotation: int):
        if rotation == 0:
            return a
        k = self._ksw(a.level)
        if k is None:
            return super().rotate(a, rotation)
        return k.rotate(a, rotation, self.keygen)

    @timed("CKKS::mul", keyswitch=True)
    def mul(self, a, b):
        a, b = self._adjust(a, b)
        k = self._ksw(a.level)
        if k is None:
            return super().mul(a, b)
        return k.relinearize(self.mul3(a, b), self.keygen)

    def relinearize(self, c3):
        k = self._ksw(c3.c2.num_q)
        if k is None:
            return super().relinearize(c3)
        return k.relinearize(c3, self.keygen)

    def key_residency_report(self) -> str:
        per_dev = sum(k.key_memory_resident_bytes()
                      for k in self._spmd.values() if k is not None)
        d = self.digit_mesh.shape["digit"]
        s = self.digit_mesh.shape["slot"]
        return (f"[RT_STAT] spmd key residency: {per_dev / 2**20:.1f} "
                f"MB/device over digit={d} x slot={s}")
