"""Helpers of the benchmark's tests: the test-only cell (ResNet-20 cut
to its first convolution, plain kernels on the CPU)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fhebench import cells  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED = 2**31 + 12345        # a driver-sized seed, past 32 signed bits


def stem_cell(limit: float = 0.05) -> cells.Cell:
    bench = cells.benchmark()
    return cells.Cell("resnet20_stem_test.warm", 1,
                      cells.config("resnet20_stem_test", base=DATA),
                      cells.traffic("warm"), {"logit_gap": {"limit": limit}},
                      bench["end_to_end"], bench["per_layer"])
