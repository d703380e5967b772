"""PyTorch port: scripts/torch_report.py renders RESULTS_TORCH.md from
the committed results/torch_*.json: every row with a time or a memory
figure names its card, nothing of the JAX package's results (its TPU
figures, BENCH_r*.json, results/<model>.json, results/bench_micro_*.json)
appears, bench_micro_torch.py's files render as op tables, and the
committed RESULTS_TORCH.md is what the script renders now."""

import json
import os

from ace_tpu_torch.utils.scripts import load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = load_script("torch_report")


def _table_rows(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("| ") and not ln.startswith("| model |")
            and not ln.startswith("| file |")]


def test_renders_the_committed_results_beside_their_card():
    text = R.render()
    rows = _table_rows(text)
    assert rows
    cards = {r["card"] for r in R.latency_rows() + R.accuracy_rows()}
    assert cards and "card not recorded" not in cards
    for row in rows:
        assert any(c in row for c in cards), row
    assert "TPU" not in text
    assert "resnet110_cifar10" in text and "7531.12" in text


def test_committed_results_torch_md_is_current():
    with open(os.path.join(REPO, "RESULTS_TORCH.md")) as f:
        assert f.read() == R.render()


def test_reads_only_the_port_results(tmp_path):
    """A JAX-package result file and a row without a card: the first is
    not read, the second is labelled as such."""
    res = tmp_path / "results"
    res.mkdir()
    (res / "resnet20_cifar10.json").write_text(json.dumps(
        [{"seconds": 1.0, "card": "TPU v5e"}]))
    (res / "torch_resnet20_cifar10.json").write_text(json.dumps(
        [{"seconds": 200.0, "argmax_agree": True, "max_err": 0.1,
          "params": {"N": 32768, "L": 33}},
         {"seconds": 100.0, "argmax_agree": True, "max_err": 0.2,
          "card": "NVIDIA H100 80GB HBM3, 700.00 W",
          "max_memory_allocated": 2 ** 31}]))
    text = R.render(str(tmp_path))
    assert "TPU" not in text
    rows = _table_rows(text)
    assert len(rows) == 2
    assert any(r.startswith("| resnet20_cifar10 | card not recorded | 1 "
                            "| 200.0 |") for r in rows)
    assert any("| NVIDIA H100 80GB HBM3, 700.00 W | 1 | 100.0 |" in r
               and "| 2.00 |" in r and "| 14.5x |" in r for r in rows)
    out = tmp_path / "R.md"
    assert R.main(["--out", str(out)]) == 0
    assert out.read_text() == R.render()


def test_renders_the_op_microbenchmarks_beside_their_card(tmp_path):
    """results/torch_bench_micro_*.json: one table per file, every op row
    naming the file's card (or that none was recorded); the JAX
    package's results/bench_micro_*.json is not read."""
    res = tmp_path / "results"
    res.mkdir()
    (res / "bench_micro_r05_2e16.json").write_text(json.dumps(
        {"backend": "tpu", "degree": 65536, "seconds": {"add": 1e-3}}))
    (res / "torch_bench_micro_2e16.json").write_text(json.dumps(
        {"backend": "cuda", "degree": 65536, "num_q": 24,
         "first_mod_size": 60, "scaling_mod_size": 56, "iters": 10,
         "seconds": {"add": 2e-4, "rotate": 0.025},
         "key_switches_per_s": 40.0,
         "card": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    (res / "torch_bench_micro_cpu.json").write_text(json.dumps(
        {"backend": "cpu", "degree": 1024, "num_q": 4, "iters": 1,
         "seconds": {"add": 1e-4}, "card": None}))
    text = R.render(str(tmp_path))
    assert "tpu" not in text.lower()
    rows = _table_rows(text)
    assert rows == [
        "| torch_bench_micro_2e16.json | NVIDIA H100 80GB HBM3, 700.00 W "
        "| add | 0.200 | 5000.0 |",
        "| torch_bench_micro_2e16.json | NVIDIA H100 80GB HBM3, 700.00 W "
        "| rotate | 25.000 | 40.0 |",
        "| torch_bench_micro_2e16.json | NVIDIA H100 80GB HBM3, 700.00 W "
        "| (key switches/s) | - | 40.0 |",
        "| torch_bench_micro_cpu.json | card not recorded | add | 0.100 "
        "| 10000.0 |"]
    assert "N=65536 num_q=24 (60/56-bit primes), 10 iterations" in text
