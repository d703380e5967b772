"""PyTorch port: the benchmark entry points bench_torch.py and
bench_micro_torch.py on the CPU (their plain versions at a small ring):
bench_torch's chained NTT bit for bit against ace_tpu's (JAX on the CPU),
its one JSON line in bench.py's schema, its ResNet-20 line from a rows
file and its refusals; bench_micro_torch's JSON in bench_micro.py's
keys; both defaulting to the card; and chip_smoke.py's phase 10
rehearsed at N = 256."""

import ast
import json
import os

import jax
import numpy as np
import pytest
import torch

from ace_tpu.ops import ntt as ace_ntt

import bench_micro_torch as BM
import bench_torch as BT
from tests.torch_port_util import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _json_dump_keys(path: str) -> list:
    """The keys of the dict literal that `path` passes to json.dump."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dump"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dump of a dict literal in {path}")


def test_chained_ntt_equals_ace_tpus():
    """bench_torch's inputs and chain at N = 2^10, 8 limbs, 3 links: the
    port's plain K3 ladder chained 3 times equals ace_tpu.ops.ntt.ntt_fwd
    chained 3 times on the same primes and data."""
    n, limbs = 1 << 10, 8
    primes, tables, x = BT.ntt_inputs(n, limbs, "cpu")
    got = to_np(BT.chain(x, tables, 3))
    t = ace_ntt.make_ntt_tables(primes, n, four_step=False)
    fwd = jax.jit(ace_ntt.ntt_fwd)
    r = jax.numpy.asarray(to_np(x))
    for _ in range(3):
        r = fwd(r, t)
    np.testing.assert_array_equal(got, np.asarray(r))
    assert not np.array_equal(got, to_np(x))


def test_ntt_mode_prints_one_json_line(capsys):
    assert BT.main(["--ntt", "--device", "cpu", "--degree", "1024"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "ntt_2^16_per_s_per_chip"
    assert line["unit"] == "ntt/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert "CPU baseline" in err and "no card" in err


def test_resnet20_line_takes_the_median_steady_image(tmp_path):
    rows = [{"image": 0, "seconds": 300.0, "card": CARD},
            {"image": 2, "seconds": 90.0, "card": CARD},
            {"image": 1, "seconds": 70.0, "card": CARD},
            {"image": 3, "seconds": 80.0, "card": CARD}]
    path = tmp_path / "torch_resnet20_cifar10.json"
    path.write_text(json.dumps(rows))
    line = BT.resnet20_metric(json.loads(path.read_text()), CARD)
    assert line == {"metric": "resnet20_cifar10_encrypted_s_per_image",
                    "value": 80.0, "unit": "s/image",
                    "vs_baseline": round(1453.96 / 80.0, 2)}
    # another power limit of the same card is the same card
    assert BT.resnet20_metric(rows, "NVIDIA H100 80GB HBM3, 500.00 W") \
        == line
    assert BT.resnet20_metric(rows[:1], CARD)["value"] == 300.0


def test_resnet20_line_refuses_rows_of_no_or_another_card():
    rows = [{"image": 0, "seconds": 300.0, "card": CARD},
            {"image": 1, "seconds": 70.0}]
    with pytest.raises(ValueError, match="not the present card"):
        BT.resnet20_metric(rows, CARD)
    rows[1]["card"] = "NVIDIA A100-SXM4-80GB, 400.00 W"
    with pytest.raises(ValueError, match="not the present card"):
        BT.resnet20_metric(rows, CARD)
    with pytest.raises(ValueError, match="no images"):
        BT.resnet20_metric([], CARD)


def test_bench_micro_writes_bench_micros_keys(tmp_path):
    out = tmp_path / "bm.json"
    assert BM.main(["--device", "cpu", "--degree", "1024", "--num-q", "4",
                    "--first-mod-size", "40", "--scaling-mod-size", "33",
                    "--iters", "1", "--json", str(out)]) == 0
    d = json.loads(out.read_text())
    assert list(d) == _json_dump_keys(os.path.join(REPO, "bench_micro.py")) \
        + ["card"]
    assert d["backend"] == "cpu" and d["card"] is None
    assert (d["degree"], d["num_q"], d["iters"]) == (1024, 4, 1)
    assert list(d["seconds"]) == ["add", "add_plain", "mul_plain",
                                  "mul_relin", "rescale", "rotate",
                                  "ntt_fwd", "ntt_inv"]
    assert all(v > 0 for v in d["seconds"].values())
    assert d["key_switches_per_s"] == round(1.0 / d["seconds"]["rotate"], 1)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BT.main(["--ntt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BM.main(["--degree", "1024", "--num-q", "4"])
    with pytest.raises(SystemExit):
        BT.main(["--device", "cpu"])  # the ResNet-20 line is a card's


def test_chip_smoke_bench_phase_on_cpu():
    """chip_smoke.py's phase 10 at N = 256 (22 q primes, a 16-slot sparse
    bootstrap) through bench_torch's and bench_micro_torch's functions:
    the decodes within their bounds, the bootstraps regaining levels;
    on the CPU no kernel launches."""
    import chip_smoke
    out = chip_smoke.phase_bench(device="cpu", degree=256, num_q=22,
                                 iters=1, sparse=16)
    assert out["err_rotate"] <= chip_smoke.BENCH_TOL
    assert out["err_mul+relin+rescale"] <= chip_smoke.BENCH_TOL
    assert set(out["bootstrap_s"]) == {"bootstrap_full_cold",
                                       "bootstrap_full_warm",
                                       "bootstrap_sparse_16_cold"}
    for k in out["bootstrap_s"]:
        assert out[f"err_{k}"] < chip_smoke.BTS_TOL
    assert out["bench_ntt"]["metric"] == "ntt_2^16_per_s_per_chip"
    assert list(out["ops_ms"]) == ["add", "add_plain", "mul_plain",
                                   "mul_relin", "rescale", "rotate",
                                   "ntt_fwd", "ntt_inv"]
    assert out["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                              "K5": 0, "K6": 0}
