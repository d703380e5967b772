"""PyTorch port: scripts/torch_report.py renders RESULTS_TORCH.md from
the committed results/torch_*.json: every row with a time or a memory
figure names its card, nothing of the JAX package's results (its TPU
figures, BENCH_r*.json, results/<model>.json) appears, and the
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
