"""PyTorch port: the compile driver and its inputs and outputs against
ace_tpu's — the reference-style option parser, the manifest and weight
file both drivers write for a tiny ONNX model (written with the port's
onnx_pb2 by chip_smoke.write_onnx), the contexts both packages rebuild
from that manifest, and load_model."""

import dataclasses
import json
import os

import numpy as np
import pytest

from ace_tpu import driver as adriver
from ace_tpu.models import resnet as M
from ace_tpu.runtime.context import FheContext
from ace_tpu.utils import options
from ace_tpu_torch import driver as tdriver
from ace_tpu_torch.compiler.onnx_front import NNGraph, NNOp, load_onnx
from ace_tpu_torch.models import resnet as TM
from ace_tpu_torch.runtime.context import FheContext as TFheContext
from ace_tpu_torch.utils import options as toptions

import chip_smoke

from tests.torch_port_util import assert_poly_equal, one_thread

# tests/test_options.py's lines (scripts/build_resnet20_cifar10.sh)
LINES = [
    ["model.onnx", "-CKKS:sk_hw=192:q0=60:sf=56",
     "-SIHE:relu_vr=/relu/Relu=4", "-VEC:rtt:conv_fast",
     "-P2C:df=weights.msg:fp", "-trace"],
    ["-CKKS:sk_hw=192:q0=60:sf=56:sec=0", "-P2C:lib=ant:df=w.msg:fp",
     "-SIHE:relu_vr=/relu/Relu=4;/layer1/relu/Relu=6.5:relu_vr_def=3:"
     "relu_depth=9", "-perf", "-show", "m.onnx"],
]


@pytest.mark.parametrize("argv", LINES)
def test_parse_args_equal(argv):
    cfg, glob, extras = options.parse_args(argv)
    tcfg, tglob, textras = toptions.parse_args(argv)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(tglob) == dataclasses.asdict(glob)
    assert textras == extras
    for arg in argv[1:4]:
        assert toptions.parse_group(arg) == options.parse_group(arg)


def _tiny_graph():
    """Conv(1->2, 3x3) -> ReLU -> GlobalAveragePool on 4x4 (the tiny CNN
    of tests/test_e2e_tiny.py)."""
    rng = np.random.default_rng(17)
    w = {"w1": rng.uniform(-0.5, 0.5, (2, 1, 3, 3)).astype(np.float32),
         "b1": rng.uniform(-0.1, 0.1, 2).astype(np.float32)}
    ops = [NNOp("Conv", "conv1", ["input", "w1", "b1"], ["c1"],
                {"dilations": [1, 1], "group": 1, "kernel_shape": [3, 3],
                 "pads": [1, 1, 1, 1], "strides": [1, 1]},
                (1, 1, 4, 4), (1, 2, 4, 4)),
           NNOp("Relu", "relu1", ["c1"], ["r1"], {}, (1, 2, 4, 4),
                (1, 2, 4, 4)),
           NNOp("GlobalAveragePool", "gap", ["r1"], ["out"], {},
                (1, 2, 4, 4), (1, 2, 1, 1))]
    return NNGraph(ops, w, "input", (1, 1, 4, 4), "out")


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """Both drivers' manifest and weight file for the tiny model."""
    tmp = tmp_path_factory.mktemp("driver")
    onnx = str(tmp / "tiny.onnx")
    chip_smoke.write_onnx(_tiny_graph(), onnx)
    out = {}
    for name, mod in (("ace_tpu", adriver), ("port", tdriver)):
        man, wf = tmp / f"{name}.json", tmp / f"{name}.msg"
        assert mod.main([onnx, "-CKKS:sk_hw=16:q0=50:sf=40:sec=0",
                         "-SIHE:relu_vr_def=2:relu_depth=9",
                         f"-P2C:df={wf}", "-o", str(man)]) == 0
        out[name] = (json.loads(man.read_text()), wf.read_bytes(), man)
    return onnx, out


@pytest.mark.parametrize("which", ["tiny", "resnet8"])
def test_onnx_writer_round_trips(tmp_path, which):
    graph = _tiny_graph() if which == "tiny" else TM.build_resnet_cifar(1)
    f = str(tmp_path / "m.onnx")
    chip_smoke.write_onnx(graph, f)
    back = load_onnx(f)
    assert [dataclasses.asdict(o) for o in back.ops] == \
        [dataclasses.asdict(o) for o in graph.ops]
    assert back.weights.keys() == graph.weights.keys()
    for k, v in graph.weights.items():
        assert back.weights[k].dtype == v.dtype
        np.testing.assert_array_equal(back.weights[k], v)


def test_drivers_write_equal_manifests_and_weight_files(compiled):
    _, out = compiled
    (m, w, _), (tm, tw, _) = out["ace_tpu"], out["port"]
    assert tw == w and len(w) > 0
    skip = ("compile_seconds", "weights_file")
    assert {k: v for k, v in tm.items() if k not in skip} == \
        {k: v for k, v in m.items() if k not in skip}
    assert m["rotate_indices"] and m["scheme"]["poly_degree"] == 64


def test_from_manifest_prewarms_the_same_rotations(compiled):
    """A shrunk manifest (as tests/test_manifest_resume.py shrinks it)
    rebuilds a context in each package: the same rotation keys
    pre-warmed, the weight file open, a weight decoding to the same
    residues."""
    _, out = compiled
    data, _, man = out["port"]
    data = dict(data)
    data["scheme"] = dict(data["scheme"], mul_level=3, q_part_num=2)
    data["rotate_indices"] = data["rotate_indices"][:6]
    path = str(man.with_name("shrunk.json"))
    with open(path, "w") as f:
        json.dump(data, f)
    ctx = FheContext.from_manifest(path, max_rot_keys=4)
    tctx = TFheContext.from_manifest(path, max_rot_keys=4, device="cpu")
    assert tctx.params.degree == 64 and tctx.params.num_q == 4
    assert 1 <= len(tctx.keygen._rot_keys) <= 4
    assert sorted(tctx.keygen._rot_keys) == sorted(ctx.keygen._rot_keys)
    assert tctx.manifest == data
    assert tctx.pt_mgr.bio_engine in ("io_uring", "threadpool")
    assert_poly_equal(tctx.pt_mgr.get("w1", level=2).poly,
                      ctx.pt_mgr.get("w1", level=2).poly)
    assert tctx.key_memory_bytes() == ctx.key_memory_bytes()
    assert "key memory" in tctx.finalize()
    data["weights_file"] = "missing.msg"
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(FileNotFoundError, match="missing.msg"):
        TFheContext.from_manifest(path, max_rot_keys=4, device="cpu")


def test_load_model():
    g, tg = M.load_model("resnet110_cifar10"), TM.load_model(
        "resnet110_cifar10")
    assert [dataclasses.asdict(o) for o in tg.ops] == \
        [dataclasses.asdict(o) for o in g.ops]
    assert tg.weights.keys() == g.weights.keys()
    for k in g.weights:
        np.testing.assert_array_equal(tg.weights[k], g.weights[k])
    assert TM.MODEL_FILES == M.MODEL_FILES
    with pytest.raises(FileNotFoundError, match="resnet20_cifar10_pre.onnx"):
        TM.load_model("resnet20_cifar10", model_dir=os.devnull)
    assert os.path.dirname(TM.model_path("resnet20_cifar10")) == \
        os.path.join(chip_smoke.REPO, "model")


@pytest.mark.parametrize("classes", [10, 100])
def test_read_cifar_batch(tmp_path, classes):
    """The binary CIFAR reader equals ace_tpu's on a synthetic batch."""
    rec = (1 if classes == 10 else 2) + 3 * 32 * 32
    path = str(tmp_path / "batch.bin")
    np.random.default_rng(classes).integers(0, 256, 5 * rec, dtype=np.uint8
                                            ).tofile(path)
    for count in (0, 3):
        imgs, labels = M.read_cifar_batch(path, count, classes)
        timgs, tlabels = TM.read_cifar_batch(path, count, classes)
        assert timgs.shape == imgs.shape == (count or 5, 3, 32, 32)
        np.testing.assert_array_equal(timgs, imgs)
        np.testing.assert_array_equal(tlabels, labels)


def _block_graph(hw: int = 4):
    """ResNet-20's first residual block at 2 channels on hw x hw (at 4x4
    the graph of tests/test_torch_slice.py, float32 weights as an ONNX
    file holds them): Conv -> ReLU -> Conv -> ReLU -> Conv -> Add."""
    rng = np.random.default_rng(59)
    c, s = 2, (1, 2, hw, hw)
    w = {"w1": rng.uniform(-0.5, 0.5, (c, 1, 3, 3)),
         "b1": rng.uniform(-0.1, 0.1, c),
         "w2": rng.uniform(-0.3, 0.3, (c, c, 3, 3)),
         "b2": rng.uniform(-0.1, 0.1, c),
         "w3": rng.uniform(-0.3, 0.3, (c, c, 3, 3)),
         "b3": rng.uniform(-0.1, 0.1, c)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    conv = {"dilations": [1, 1], "group": 1, "kernel_shape": [3, 3],
            "pads": [1, 1, 1, 1], "strides": [1, 1]}
    ops = [NNOp("Conv", "conv1", ["input", "w1", "b1"], ["c1"], conv,
                (1, 1, hw, hw), s),
           NNOp("Relu", "relu1", ["c1"], ["r1"], {}, s, s),
           NNOp("Conv", "conv2", ["r1", "w2", "b2"], ["c2"], conv, s, s),
           NNOp("Relu", "relu2", ["c2"], ["r2"], {}, s, s),
           NNOp("Conv", "conv3", ["r2", "w3", "b3"], ["c3"], conv, s, s),
           NNOp("Add", "add", ["c3", "r1"], ["out"], {}, s, s)]
    return NNGraph(ops, w, "input", (1, 1, hw, hw), "out")


def test_chip_smoke_runtime_services_on_cpu():
    """chip_smoke.py's phase 7 (compile driver, context from the manifest,
    validated run with a perturbed input, checkpoint resume) on the CPU at
    a tiny size. The key LRU holds every key of ops[:6], so no key is
    made twice and the resume stays bit-exact; on the CPU no kernel
    counter moves."""
    g = _block_graph()
    img = np.random.default_rng(3).uniform(-1, 1, (1, 4, 4))
    vr_default, vr = TM.calibrate_relu_ranges(g, [img], 4.0, {})
    res = chip_smoke.phase_runtime_services(
        g, img, vr_default, vr, device="cpu",
        ckks_flags="-CKKS:sk_hw=16:q0=50:sf=40:sec=0", prewarm_keys=40,
        validated_ops=3, expect=(64, 30))
    assert res["rotations"] > 0 and res["bio_engine"] != "mmap"
    assert res["checks"] > 3 and res["ckpt_bytes"] > 0
    assert 0 < res["key_hits"] <= 40
    assert res["launches"] and not any(res["launches"].values())


def test_chip_smoke_resnet_phase_on_cpu():
    """chip_smoke.py's phase 6 through the model zoo's path (cfg_for,
    shared_context, run_model) on the CPU at a tiny size: the block graph
    with a bootstrap before each of its two ReLUs at N = 64. The phase
    holds its gates (finite logits, argmax, max_err, the zoo's row, the
    bootstrap count); main() holds the launch gate, and on the CPU no
    kernel counter moves."""
    g = _block_graph()
    img = np.random.default_rng(3).uniform(-1, 1, (1, 4, 4))
    res = chip_smoke.phase_resnet20(
        device="cpu", graph=g, img=img, name="block", bootstraps=2,
        hamming_weight=16, first_mod_size=50, scaling_mod_size=40)
    assert res["bootstraps"] == 2 and res["keys"] > 0
    assert res["max_err"] <= 0.1 * res["max_plain"]
    assert res["peak_gib"] == 0.0
    assert res["launches"] and not any(res["launches"].values())


def _spmd_slice():
    """phase 4's model for the world rehearsals at degree 2^10: the block
    graph on 16x16 (select_params picks N = 2^10) with the chain set to
    34 q primes as phase 4 sets it, and its reference residues from a
    single-device run, as main() takes phase 4's."""
    from ace_tpu_torch.compiler.scheme_info import (SchemeConfig,
                                                    select_params)
    from ace_tpu_torch.ops import modops
    from ace_tpu_torch.runtime.context import FheContext as TContext
    g = _block_graph(16)
    img = np.random.default_rng(3).uniform(-1, 1, (1, 16, 16))
    vr_default, vr = TM.calibrate_relu_ranges(g, [img], 4.0, {})
    cfg = SchemeConfig(security_level=0, hamming_weight=16,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=9, relu_value_range=vr_default,
                       relu_ranges=vr, use_bootstrap=False)
    info = select_params(g, cfg)
    assert (info.poly_degree, info.q_part_num) == (1024, 3)
    info.mul_level = chip_smoke.NUM_Q - 1
    sm = {"graph": g, "cfg": cfg, "info": info, "img": img, "out_len": 32}
    ctx = TContext(scheme_info=info, max_rot_keys=100, device="cpu")
    model = TM.compile_model(g, cfg, ctx=ctx, num_classes=32)
    TM.infer_encrypted(model, img)
    ct = ctx.get_output_data("output")
    return sm, (modops.to_numpy(ct.c0.data), modops.to_numpy(ct.c1.data))


def test_chip_smoke_spmd_phase_on_cpu():
    """chip_smoke.py's phase 9 as main() calls it, at degree 2^10 on the
    CPU (gloo for all three worlds): 9a at ResNet-20's chain (34 q
    primes, 3 digits) on 3 x 2 ranks; 9b on 3 x 1 ranks with
    _spmd_slice()'s model and reference; 9c on one rank. The phase holds
    every rank bit-exact itself; on the CPU no kernel counter moves."""
    with one_thread():
        sm, want = _spmd_slice()
        res = chip_smoke.phase_spmd(
            device="cpu", kw=chip_smoke.spmd_kw(1024), sm=sm, want=want)
    assert sorted(res["seconds"]) == ["9a", "9a_single", "9b", "9c"]
    assert sorted(res["launches_spmd"]) == [
        "K1", "K2", "K3", "K4", "K5", "K6"]
    assert not any(res["launches_spmd"].values())


def test_chip_smoke_limb_phase_on_cpu():
    """chip_smoke.py's phase 9d as main() calls it, at degree 2^10 on the
    CPU: a 2 x 2 (dp x limb) gloo world at ResNet-20's chain, each dp row
    bit-identical to the single-device Evaluator on its own message, and
    _spmd_slice()'s model equal to its single-device residues on every
    rank. The phase holds both itself; main() holds the launch gate, and
    on the CPU no kernel counter moves."""
    with one_thread():
        sm, want = _spmd_slice()
        res = chip_smoke.phase_limb(
            device="cpu", kw=chip_smoke.spmd_kw(1024), sm=sm, want=want)
    assert sorted(res["seconds"]) == ["9d", "9d_single"]
    assert sorted(res["launches_limb"]) == [
        "K1", "K2", "K3", "K4", "K5", "K6"]
    assert not any(res["launches_limb"].values())
