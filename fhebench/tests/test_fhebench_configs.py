"""Each configuration as the harness builds it on the CPU: the layers
its depth gives, calibration targets that name only its ReLUs, and a
reference output of one value a class."""

import pytest
import torch

from fhb_util import SEED
from fhebench import cells, model, reference

# the 6n+2 CIFAR ResNet with projection shortcuts: 6n + 1 3x3 convs and
# two 1x1 stride-2 projections, 6n + 1 ReLUs, 3n adds, one classifier
# over the 64 pooled channels
SHAPES = {
    "resnet20_cifar10": {"conv": 21, "relu": 19, "add": 9, "classes": 10},
    "resnet32_cifar100": {"conv": 33, "relu": 31, "add": 15, "classes": 100},
}
CONFIGS = [c["name"] for c in cells.benchmark()["configs"]]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_layers_of_the_depth(name):
    want = SHAPES[name]
    net = model.layers(cells.config(name)["architecture"])
    kinds = [ly.op for ly in net]
    for op in ("conv", "relu", "add"):
        assert kinds.count(op) == want[op], op
    proj = [ly for ly in net if ly.op == "conv" and ly.k == 1]
    assert len(proj) == 2 and all(ly.stride == 2 for ly in proj)
    assert [ly.name for ly in proj] == [
        "/layer2/layer2.0/downsample/downsample.0/Conv",
        "/layer3/layer3.0/downsample/downsample.0/Conv"]
    (gemm,) = [ly for ly in net if ly.op == "gemm"]
    assert (gemm.cin, gemm.cout) == (64, want["classes"])
    assert kinds[-3:] == ["gap", "reshape", "gemm"]


@pytest.mark.parametrize("name", CONFIGS)
def test_calibration_targets_name_only_relus(name):
    cfg = cells.config(name)
    cal = cfg["calibration"]
    relus = {ly.name for ly in model.layers(cfg["architecture"])
             if ly.op == "relu"}
    assert cal["targets"] and set(cal["targets"]) <= relus
    assert all(t > 0 for t in cal["targets"].values()) and cal["default"] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_gives_one_value_a_class(name):
    cfg = cells.config(name)
    arch, cal = cfg["architecture"], cfg["calibration"]
    net = model.layers(arch)
    w = model.make_weights(net, cfg["weights"]["seed"], "cpu")
    batch = model.draw_images(torch.Generator().manual_seed(cal["seed"]),
                              cal["images"], arch["image"], cal["low"],
                              cal["high"], "cpu")
    w = model.calibrate(net, w, batch, cal["targets"], cal["default"])
    imgs = model.draw_images(torch.Generator().manual_seed(SEED), 2,
                             arch["image"], -1.5, 1.5, "cpu")
    out = reference.forward(net, w, imgs, arch["classes"])
    assert out.shape == (2, arch["classes"]) and out.dtype == torch.float64
    assert torch.isfinite(out).all() and not torch.equal(out[0], out[1])
