#!/usr/bin/env python3
"""Count the ops of one encrypted LLaMA attention block without running
any arithmetic.

    python3 scripts/torch_attention_counts.py [--seq 128] [--d 128]

Runs the port's models/llama_fhe.encrypted_attention over a stub
evaluator and encoder whose methods return their first ciphertext, with
the Chebyshev evaluations (exp, the rsqrt estimate) stubbed the same
way, on chip_smoke.attention_data's weights and ranges. It prints, as
one JSON object, how many times the block calls each evaluator method,
the distinct rotation amounts (one rotation key each) and the mask
encodes. The counts are exact for the block's own code; the two
Chebyshev evaluations add ciphertext products and rescales but no
rotation. Needs no card: it runs in a second on any CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def count(seq: int, d: int) -> dict:
    import chip_smoke
    from ace_tpu_torch.ckks import nonlinear as NL
    from ace_tpu_torch.models import llama_fhe as LF

    calls = collections.Counter()
    rots = set()

    class Ct:
        level = 50

    class Ev:
        params = types.SimpleNamespace(degree=2 * seq * d)

        def __getattr__(self, name):
            def op(ct, *a, **k):
                calls[name] += 1
                if name == "rotate":
                    rots.add(a[0])
                return ct
            return op

    class Enc:
        def encode_cached(self, *a, **k):
            calls["encode_cached"] += 1

    def cheby(ev, ct, *a, **k):
        calls["chebyshev"] += 1
        return ct

    saved = NL.eval_fn
    NL.eval_fn = cheby
    try:
        w, _, ranges = chip_smoke.attention_data(seq, d)
        LF.encrypted_attention(Ev(), Enc(), Ct(), w, seq, d, **ranges)
    finally:
        NL.eval_fn = saved
    return {"seq": seq, "d": d, "calls": dict(sorted(calls.items())),
            "rotation_keys": len(rots)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d", type=int, default=128)
    a = ap.parse_args()
    print(json.dumps(count(a.seq, a.d)))


if __name__ == "__main__":
    main()
