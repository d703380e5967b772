"""PyTorch port: the model-zoo runner and the accuracy harness
(scripts/torch_zoo.py, scripts/torch_accuracy.py) against ace_tpu's
scripts/zoo.py and scripts/accuracy.py: ResNet-110's configuration built
by zoo.py's steps in both packages, the shared context, and the
per-model run bit-identical to compile_model plus infer_encrypted at a
tiny size on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest

from ace_tpu.compiler.relu_ranges import ranges_for
from ace_tpu.compiler.scheme_info import SchemeConfig, select_params
from ace_tpu.models import resnet as M
from ace_tpu_torch.ckks.keygen import switch_key_nbytes
from ace_tpu_torch.compiler import scheme_info as TS
from ace_tpu_torch.models import resnet as TM
from ace_tpu_torch.runtime.context import FheContext as TFheContext
from ace_tpu_torch.runtime.timing import TIMING
from ace_tpu_torch.utils.scripts import load_script

from tests.test_torch_driver import _block_graph
from tests.torch_port_util import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the zoo's schema (scripts/zoo.py) and the port's card fields
ZOO_ROW = {"image", "seconds", "max_err", "argmax_agree", "weights",
           "params"}
CARD = {"card", "max_memory_allocated", "stats"}
ACCURACY = {"model", "images", "agree", "max_err", "per_image", "synthetic"}
# a tiny scheme with bootstrapping (N = 64) for the CPU
TINY = dict(hamming_weight=16, first_mod_size=50, scaling_mod_size=40)


Z = load_script("torch_zoo")
A = load_script("torch_accuracy")


def _ace_cfg(name, graph=None, images=None, relu_depth=9):
    """zoo.py's cfg_for, step for step, in ace_tpu."""
    vr_default, vr = ranges_for(name)
    if graph is not None:
        vr_default, vr = M.calibrate_relu_ranges(graph, images, vr_default,
                                                 vr)
    return SchemeConfig(security_level=0, hamming_weight=192,
                        first_mod_size=60, scaling_mod_size=56,
                        relu_mul_depth=relu_depth,
                        relu_value_range=vr_default, relu_ranges=vr,
                        use_bootstrap=True)


def test_resnet110_cfg_and_params_equal():
    name = "resnet110_cifar10"
    imgs = np.random.default_rng(1).uniform(-1.5, 1.5, (1, 3, 32, 32))
    np.testing.assert_array_equal(Z.zoo_images(1), imgs)
    g, tg = M.load_model(name), TM.load_model(name)
    for images in (None, imgs):
        want = _ace_cfg(name, None if images is None else g, images)
        got = Z.cfg_for(name, None if images is None else tg, images)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        si, tsi = select_params(g, want), TS.select_params(tg, got)
        assert dataclasses.asdict(tsi) == dataclasses.asdict(si)
        assert (tsi.poly_degree, tsi.mul_level, tsi.input_level) == \
            (32768, 33, 2)
    # calibration widened some of the tuned ranges
    assert got.relu_ranges != Z.cfg_for(name).relu_ranges
    assert Z.weights_of(name) == "synthetic-calibrated"


def _info(degree, level, rotations=()):
    return TS.SchemeInfo(poly_degree=degree, mul_level=level,
                         first_mod_size=50, scaling_mod_size=40,
                         q_part_num=2, p_prime_num=2, security_level=0,
                         hamming_weight=16, max_msg_len=8,
                         bootstrap_depth=0, rotate_indices=rotations)


def test_shared_context_takes_the_largest_chain():
    infos = {"a": _info(64, 5, (1, 2)), "b": _info(64, 8, (3,)),
             "c": _info(64, 7)}
    shared, ctx = Z.shared_context(infos, device="cpu")
    assert shared == dataclasses.replace(infos["b"], rotate_indices=())
    assert (ctx.params.degree, ctx.params.num_q) == (64, 9)
    with pytest.raises(ValueError, match="a params exceed"):
        Z.shared_context(dict(infos, d=_info(128, 3)), device="cpu")


def test_rotation_key_lru_defaults_to_the_byte_budget():
    """--max-rot-keys 0 (the port's default, zoo.py's is 90) sizes the LRU
    from compile_model's ROT_KEY_BUDGET_BYTES, as compile_model does."""
    assert Z.parse_args([]).max_rot_keys == 0
    info = _info(64, 8)
    _, ctx = Z.shared_context({"m": info}, device="cpu")
    want = max(16, TM.ROT_KEY_BUDGET_BYTES // switch_key_nbytes(ctx.params))
    assert ctx.keygen.max_rot_keys == want
    g = _block_graph()
    own = TM.compile_model(g, Z.cfg_for("m", **TINY), device="cpu")
    assert own.ctx.keygen.max_rot_keys == max(
        16, TM.ROT_KEY_BUDGET_BYTES // switch_key_nbytes(own.ctx.params))
    _, ctx = Z.shared_context({"m": info}, max_rot_keys=7, device="cpu")
    assert ctx.keygen.max_rot_keys == 7


def test_run_model_bit_identical_to_compile_and_infer(monkeypatch):
    """run_model on the shared context gives the residues and the decoded
    logits of compile_model plus infer_encrypted on an equal context;
    its rows carry zoo.py's keys and the card fields."""
    monkeypatch.setattr(TIMING, "enabled", True)
    g = _block_graph()
    imgs = np.random.default_rng(3).uniform(-1, 1, (1, 1, 4, 4))
    cfg = Z.cfg_for("block", g, imgs, **TINY)
    si = TS.select_params(g, cfg)
    assert si.poly_degree == 64 and si.bootstrap_depth > 0
    _, ctx = Z.shared_context({"block": si}, device="cpu")
    got = []
    measured_infer = Z.measured_infer

    def infer(model, img):
        out, stats = measured_infer(model, img)
        got.append((model.ctx._io_outputs["output"], out))
        return out, stats

    monkeypatch.setattr(Z, "measured_infer", infer)
    rows = Z.run_model("block", g, cfg, ctx, imgs, 4)

    want_ctx = TFheContext(scheme_info=si, device="cpu")
    model = TM.compile_model(g, cfg, ctx=want_ctx, num_classes=4)
    for (ct, out), img, row in zip(got, imgs, rows):
        dec = TM.infer_encrypted(model, img)
        want = want_ctx._io_outputs["output"]
        for a, b in ((ct.c0, want.c0), (ct.c1, want.c1)):
            np.testing.assert_array_equal(to_np(a.data), to_np(b.data))
        np.testing.assert_array_equal(out, dec)
        plain = TM.infer_plain(g, img)[:4]
        assert row["stats"]["logits"] == [float(x) for x in dec[:4]]
        assert row["stats"]["plain_logits"] == [float(x) for x in plain]
        assert row["max_err"] == float(np.max(np.abs(dec - plain)))
        assert row["argmax_agree"] == (np.argmax(dec) == np.argmax(plain))
    assert [set(r) for r in rows] == [ZOO_ROW | CARD]
    assert rows[0]["image"] == 0
    assert rows[0]["params"] == dict(
        N=64, L=si.mul_level, hamming_weight=16,
        security=TS.security_posture(si)["detail"])
    assert rows[0]["weights"] == "reference-trained"
    assert rows[0]["card"] is None and rows[0]["max_memory_allocated"] is None
    st = rows[0]["stats"]
    assert st["bootstraps"] == 2 and st["rotation_keys"] > 0
    assert st["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                              "K5": 0, "K6": 0}
    assert st["limbs"] == {"K3": 0, "K4": 0}
    assert st["max_plain"] > st["plain_margin"] > 0
    assert st["timing"]["RTM_BOOTSTRAP"][0] == 2


@pytest.mark.parametrize("labelled", [False, True])
def test_accuracy_writes_accuracy_py_keys(tmp_path, monkeypatch, labelled):
    monkeypatch.setattr(TIMING, "enabled", True)
    g = _block_graph()
    n = 2 if labelled else 1
    imgs = np.random.default_rng(4).uniform(-1, 1, (n, 1, 4, 4))
    labels = np.array([3, 1]) if labelled else None
    path = str(tmp_path / "acc.json")
    out = A.run_accuracy("block", g, imgs, labels, path, device="cpu",
                         relu_depth=9, relu_range=4.0, **TINY)
    with open(path) as f:
        assert json.load(f) == out
    extra = {"accuracy_encrypted", "accuracy_plain"} if labelled else set()
    assert set(out) == ACCURACY | {"card", "max_memory_allocated",
                                   "relu_depth", "relu_range"} | extra
    assert (out["relu_depth"], out["relu_range"]) == (9, 4.0)
    assert (out["model"], out["images"], out["synthetic"]) == \
        ("block", n, not labelled)
    assert out["agree"] == sum(r["argmax_agree"] for r in out["per_image"])
    row_keys = {"image", "seconds", "max_err", "argmax_agree"} | CARD
    assert [set(r) for r in out["per_image"]] == \
        [row_keys | ({"label"} if labelled else set())] * n
    if labelled:
        st = [r["stats"] for r in out["per_image"]]
        assert out["accuracy_encrypted"] == np.mean(
            [s["argmax"] == lb for s, lb in zip(st, labels)])
        assert out["accuracy_plain"] == np.mean(
            [s["plain_argmax"] == lb for s, lb in zip(st, labels)])


def test_accuracy_keeps_a_file_of_other_relu_settings(tmp_path):
    """torch_zoo.py's summary and torch_accuracy.py share the default
    path results/torch_accuracy_<model>.json: the accuracy run does not
    replace a file that records other ReLU settings, or none."""
    g = _block_graph()
    imgs = np.random.default_rng(4).uniform(-1, 1, (1, 1, 4, 4))
    path = tmp_path / "acc.json"
    for old in ({"model": "block"}, {"relu_depth": 9, "relu_range": 0.0},
                {"relu_depth": 13, "relu_range": 4.0}):
        path.write_text(json.dumps(old))
        with pytest.raises(FileExistsError, match="another --out"):
            A.run_accuracy("block", g, imgs, None, str(path), relu_depth=9,
                           relu_range=4.0, device="cpu", **TINY)
        assert json.loads(path.read_text()) == old
    path.write_text(json.dumps({"relu_depth": 9, "relu_range": 4.0}))
    out = A.run_accuracy("block", g, imgs, None, str(path), relu_depth=9,
                         relu_range=4.0, device="cpu", **TINY)
    assert json.loads(path.read_text()) == out


def _gate_row(**over):
    stats = dict(logits=[0.5, -1.0, 2.0], bootstraps=109,
                 launches={"K1": 3, "K2": 1, "K3": 2, "K4": 2})
    stats.update(over.pop("stats", {}))
    return dict(dict(max_err=0.9, stats=stats), **over)


@pytest.mark.parametrize("row, kw, want", [
    (_gate_row(), {}, []),
    (_gate_row(max_err=1.32), {}, ["max_err 1.32 > 1.31"]),
    (_gate_row(max_err=float("nan")), {}, ["max_err nan > 1.31"]),
    (_gate_row(max_err=5.0), dict(max_err=None), []),
    (_gate_row(stats=dict(bootstraps=108)), {},
     ["108 bootstraps, expected 109"]),
    (_gate_row(stats=dict(logits=[0.5, float("inf"), 2.0])), {},
     ["logits of shape (3,) not finite or not (3,)"]),
    (_gate_row(stats=dict(logits=[0.5, 2.0])), {},
     ["logits of shape (2,) not finite or not (3,)"]),
    (_gate_row(stats=dict(launches={"K1": 3, "K2": 0, "K3": 2, "K4": 0})),
     {}, ["kernels never launched: ['K2', 'K4']"]),
    (_gate_row(stats=dict(launches={"K1": 0, "K2": 0, "K3": 0, "K4": 0})),
     dict(kernels=False), []),
])
def test_gate_failures(row, kw, want):
    """The zoo's gates on a row: each one that fails is named, and a row
    that holds them all gives none."""
    kw = dict(dict(bootstraps=109, max_err=1.31, kernels=True), **kw)
    assert Z.gate_failures(row, 3, **kw) == want


def test_resnet110_gates():
    """ResNet-110's gates on the card: 109 bootstraps (one before each
    ReLU), max_err <= 1.31 (1.5 times ace_tpu's 0.875), every kernel
    launched; on the CPU no launch gate, and no max_err bound for a
    model without one."""
    g = TM.load_model("resnet110_cifar10")
    assert Z.gates_for("resnet110_cifar10", g, None) == dict(
        bootstraps=109, max_err=1.31, kernels=True)
    assert Z.gates_for("block", _block_graph(), "cpu") == dict(
        bootstraps=2, max_err=None, kernels=False)


@pytest.mark.parametrize("bound", [1.31, 0.0])
def test_zoo_main_records_and_enforces_the_gates(tmp_path, monkeypatch,
                                                 bound):
    """main() at a tiny size (the block graph under ResNet-110's name, the
    tiny scheme, the CPU): both files are written, the summary records
    the ReLU settings and the gates, and a failed gate ends the run with
    a non-zero exit after the files are written."""
    monkeypatch.setattr(TM, "load_model", lambda name: _block_graph())
    monkeypatch.setattr(Z, "zoo_images", lambda n: np.random.default_rng(
        1).uniform(-1, 1, (n, 1, 4, 4)))
    cfg_for = Z.cfg_for
    monkeypatch.setattr(Z, "cfg_for",
                        lambda *a, **kw: cfg_for(*a, **kw, **TINY))
    monkeypatch.setattr(Z, "MAX_ERR", {"resnet110_cifar10": bound})
    monkeypatch.setattr(TIMING, "enabled", False)
    argv = ["--models", "resnet110_cifar10", "--device", "cpu",
            "--out-dir", str(tmp_path)]
    if bound:
        Z.main(argv)
    else:
        with pytest.raises(SystemExit, match="max_err .* > 0.0"):
            Z.main(argv)
    with open(tmp_path / "torch_accuracy_resnet110_cifar10.json") as f:
        out = json.load(f)
    with open(tmp_path / "torch_resnet110_cifar10.json") as f:
        assert json.load(f) == out["per_image"]
    assert (out["relu_depth"], out["relu_range"]) == (9, 0.0)
    assert out["gates"] == dict(bootstraps=2, max_err=bound, kernels=False)
    assert bool(out["gates_failed"]) == (bound == 0.0)


def test_scripts_keep_the_missing_file_error(tmp_path):
    """Zoo names other than resnet110 load ONNX exports that are not in
    the repository: both scripts fail with the file's name."""
    with pytest.raises(FileNotFoundError, match="resnet32_cifar10_pre.onnx"):
        Z.main(["--models", "resnet32_cifar10", "--device", "cpu",
                "--out-dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="resnet56_cifar10_pre.onnx"):
        A.main(["--model", "resnet56_cifar10", "--device", "cpu",
                "--out", str(tmp_path / "a.json")])
    assert os.listdir(tmp_path) == []


def test_relu_error_script_evaluates_the_encrypted_polynomial():
    """scripts/torch_relu_error.py's approx_relu is the polynomial that
    ckks/relu.py evaluates: an encrypted depth-9 ReLU at degree 64 decodes
    to it far closer than to the exact ReLU."""
    from ace_tpu_torch.ckks import relu as relu_mod
    from ace_tpu_torch.ckks.params import CkksParams
    RE = load_script("torch_relu_error")
    ctx = TFheContext(CkksParams(degree=64, num_q=20, first_mod_size=60,
                                 scaling_mod_size=50, device="cpu"))
    msg = np.random.default_rng(6).uniform(-3.6, 3.6, 32)
    msg[:4] = [0.02, -0.02, 0.05, -0.05]  # inside the sign's transition
    ct = ctx.evaluator.encrypt(ctx.encoder.encode(msg.astype(np.complex128)))
    ctx.set_output_data("o", relu_mod.relu(ctx.evaluator, ct, 4.0, 9))
    dec = ctx.handle_output("o")
    poly = RE.approx_relu(msg, 4.0, 9)
    assert np.max(np.abs(dec - poly)) < 1e-6
    assert np.max(np.abs(poly - np.maximum(msg, 0))) > 1e-3
