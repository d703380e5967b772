"""CPU rehearsals of a run through the test-only cell (ResNet-20 cut to
its first convolution, the program's plain kernels): the last line holds
exactly the contract's keys, the reference agrees with the program's
decrypted output there and with the program's plain path over the whole
networks, and a run whose timed path is broken comes out not correct."""

import json
import time

import numpy as np
import pytest
import torch

from fhb_util import SEED, stem_cell
from fhebench import cells, model, reference, run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_the_contract_keys(trace):
    cell = stem_cell()
    res = run.run_cell(cell, SEED, 0.1, bool(trace), "cpu",
                       time.perf_counter())
    line = json.loads(run.result_line(res, "cpu", 1))
    assert list(line) == KEYS
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the reference agrees with the decrypted output at this size
    assert line["checks"]["logit_gap"]["value"] < 1e-9


def test_same_seed_same_images():
    cell = stem_cell()
    a, b = run.images_of(cell, SEED, "cpu"), run.images_of(cell, SEED, "cpu")
    c = run.images_of(cell, SEED + 1, "cpu")
    x, y, z = a(), b(), c()
    assert torch.equal(x, y) and not torch.equal(x, z)
    assert float(x.min()) >= -1.5 and float(x.max()) < 1.5


@pytest.mark.parametrize("name", [w["config"] for w in
                                  cells.benchmark()["workloads"]])
def test_reference_is_the_programs_plain_network(name):
    """Over the whole network, the float64 reference equals the
    program's packed-slot plain inference of the graph the harness hands
    it (strides, projections, pooling, the padded classifier)."""
    from ace_tpu_torch.models import resnet
    from fhebench import port
    cfg = cells.config(name)
    arch, cal = cfg["architecture"], cfg["calibration"]
    net = model.layers(arch)
    w = model.make_weights(net, cfg["weights"]["seed"], "cpu")
    batch = model.draw_images(torch.Generator().manual_seed(cal["seed"]),
                              cal["images"], arch["image"], cal["low"],
                              cal["high"], "cpu")
    w = model.calibrate(net, w, batch, cal["targets"], cal["default"])
    img = model.draw_images(torch.Generator().manual_seed(SEED), 1,
                            arch["image"], -1.5, 1.5, "cpu")
    ref = reference.forward(net, w, img, arch["classes"]).numpy()[0]
    plain = resnet.infer_plain(port.graph(net, w), img[0].numpy(),
                               n_slots=1 << 14)[:arch["classes"]]
    assert np.max(np.abs(plain - ref)) <= 1e-12 * np.max(np.abs(ref))


def _altered_answer(monkeypatch):
    from ace_tpu_torch.runtime.context import FheContext
    orig = FheContext.handle_output

    def altered(self, *a, **k):
        out = np.array(orig(self, *a, **k))
        out[3] += 0.5 * np.max(np.abs(out))
        return out

    monkeypatch.setattr(FheContext, "handle_output", altered)


def _unchanged_step(monkeypatch):
    """The convolution returns its input, from the first timed call on
    (set-up, which sizes the ring from the graph, is left whole)."""
    from ace_tpu_torch.compiler import packing
    from fhebench import port
    infer = port.Program.infer

    def broken(self, image):
        monkeypatch.setattr(packing, "conv2d", lambda be, x, *a, **k: x)
        return infer(self, image)

    monkeypatch.setattr(port.Program, "infer", broken)


@pytest.mark.parametrize("fault", [_altered_answer, _unchanged_step],
                         ids=["answer_altered", "step_returns_its_input"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    cell = stem_cell(limit=cells.limits(
        "resnet20_cifar10.warm")["logit_gap"]["limit"])
    res = run.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter())
    assert res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > \
        res["checks"]["logit_gap"]["limit"]


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    rc = run.main(["--workload", "resnet20_cifar10.warm", "--seed",
                   str(SEED), "--seconds", "10", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_traced_spans_cover_every_stage():
    """Head, the first ReLU of stages 2 and 3, and the tail from the
    last ReLU through pooling and the classifier; a network without
    ReLUs is profiled whole."""
    net = model.layers(cells.config("resnet20_cifar10")["architecture"])
    assert run.trace_segments(net) == [(0, 1), (7, 8), (13, 14), (19, None)]
    stem = model.layers(stem_cell().config["architecture"])
    assert run.trace_segments(stem) == [(0, None)]


@pytest.mark.parametrize("change", [{"loop": "open"}, {"clients": 3},
                                    {"loop": None}])
def test_a_mix_the_loop_does_not_serve_is_refused(change):
    cell = stem_cell()
    cell.traffic = {**cell.traffic, **change}
    with pytest.raises(ValueError):
        run.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter())


def test_spans_merge_without_the_time_between():
    from fhebench import devtrace
    a = devtrace.DeviceTrace(1.0, {"k1": 0.6, "k3": 0.4},
                             [("host in conv", 0.02)], 10)
    b = devtrace.DeviceTrace(0.5, {"k1": 0.5}, [("host in relu", 0.03),
                                                ("host in gemm", 0.01)], 4)
    m = devtrace.merge([a, None, b], top_gaps=2)
    assert (m.busy_s, m.events) == (1.5, 14)
    assert m.by_name == {"k1": 1.1, "k3": 0.4}
    assert m.gaps == [("host in relu", 0.03), ("host in conv", 0.02)]
    assert devtrace.merge([None]) is None
