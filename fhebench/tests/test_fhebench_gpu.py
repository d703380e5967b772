"""On the card: the controls at the cell's own size come out not
correct, and the program's own readings within the limit, on three
seeds (about 8 minutes for ResNet-20, 12 for ResNet-32). Skips without
a card; run on the card with

    python3 -m pytest fhebench/tests -m gpu -p no:cacheprovider
"""

import pytest

from fhb_util import SEED
from fhebench import cells


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_controls_fail_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fhebench import control
    c = cells.load(cell)
    lim = c.limits["logit_gap"]
    seeds = [SEED, SEED + 1, SEED + 2]
    r = control.readings(c, seeds, "cuda", [lim["program_control"]],
                         control_seeds=3)
    assert max(r["program"] + r["warmup"]) <= lim["limit"]
    assert min(r["program_control"][lim["program_control"]]) > lim["limit"]
