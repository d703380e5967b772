"""The harness finds configurations, mixes, limits and metric readers by
name, and refuses unknown or malformed names; BENCHMARK.json names only
what exists."""

import json
import os

import pytest

from fhb_util import ROOT
from fhebench import cells

BENCH = cells.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = cells.load(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert c.traffic["name"] == cell.split(".", 1)[1]
    assert c.limits["logit_gap"]["limit"] > 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "s_per_image"}
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(cells.reader(metric))


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_named_config(entry):
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


@pytest.mark.parametrize("find,name", [
    (cells.config, "resnet18_imagenet"), (cells.traffic, "burst"),
    (cells.limits, "resnet20_cifar10.cold"), (cells.reader, "mfu.train"),
    (cells.load, "resnet20_cifar10.cold"), (cells.config, "../run"),
    (cells.reader, "a/b"), (cells.traffic, "")])
def test_unknown_or_malformed_names_are_refused(find, name):
    with pytest.raises(LookupError):
        find(name)


def test_contract_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(cells.NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert all(ch.isascii() and (ch.isalnum() or ch in "_/%.-")
                   for ch in m["unit"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
