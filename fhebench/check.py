"""The comparison that decides `correct`.

Every image the run sent (the two warm-up images and every image of the
window) is decrypted by the program; the plain reference computes the
same images with the same weights in float64. The number compared is the
logit gap: over the images, the largest

    max_c |program_c - reference_c| / max_c |reference_c|

the widest gap of a logit, as a share of the image's largest reference
logit. A gap that is not finite reads as GAP_NOT_FINITE.
"""

from __future__ import annotations

import math

import numpy as np

GAP_NOT_FINITE = 1.0e300


def gaps(outputs: np.ndarray, refs: np.ndarray) -> list:
    """Each image's logit gap ([B, C] program outputs against [B, C]
    reference logits)."""
    out = []
    for o, r in zip(np.asarray(outputs, np.float64),
                    np.asarray(refs, np.float64)):
        g = float(np.max(np.abs(o - r)) / np.max(np.abs(r)))
        out.append(g if math.isfinite(g) else GAP_NOT_FINITE)
    return out


def judge(outputs: np.ndarray, refs: np.ndarray, limits: dict) -> tuple:
    """(correct, checks, each image's gap): checks maps each compared
    number's name to its value and limit."""
    g = gaps(outputs, refs)
    checks = {"logit_gap": {"value": max(g),
                            "limit": limits["logit_gap"]["limit"]}}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks, g
