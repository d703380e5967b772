"""PyTorch port: the slices end to end — a narrow graph with the op
pattern of ResNet-20's first residual block (Conv -> ReLU -> Conv -> ReLU
-> Conv -> Add), and the tiny CNN of tests/test_e2e_tiny.py with a
bootstrap before its ReLU, encrypted through both packages'
compile_model and graph runner on the same keys and the same input
ciphertext; plus the parameters and weights that chip_smoke.py takes
from ResNet-20, with and without bootstrapping."""

import dataclasses

import numpy as np

from ace_tpu.compiler.onnx_front import NNOp, NNGraph
from ace_tpu.compiler.relu_ranges import ranges_for
from ace_tpu.compiler import scheme_info as S
from ace_tpu.compiler.scheme_info import SchemeConfig, select_params
from ace_tpu.models import resnet as M
from ace_tpu_torch import interop
from ace_tpu_torch.compiler import scheme_info as TS
from ace_tpu_torch.models import resnet as TM
from ace_tpu_torch.runtime.context import FheContext as TFheContext

from tests.torch_port_util import assert_ct_equal, port_ct, port_keygen

RNG = np.random.default_rng(59)
OUT_LEN = 32  # 2 channels x 4 x 4


def _prefix_graph() -> NNGraph:
    """2 channels on 4x4, Conv->ReLU->Conv->ReLU->Conv->Add(residual)."""
    c, s = 2, (1, 2, 4, 4)
    w = {"w1": RNG.uniform(-0.5, 0.5, (c, 1, 3, 3)),
         "b1": RNG.uniform(-0.1, 0.1, c),
         "w2": RNG.uniform(-0.3, 0.3, (c, c, 3, 3)),
         "b2": RNG.uniform(-0.1, 0.1, c),
         "w3": RNG.uniform(-0.3, 0.3, (c, c, 3, 3)),
         "b3": RNG.uniform(-0.1, 0.1, c)}
    conv = {"strides": [1, 1], "pads": [1, 1, 1, 1]}
    ops = [NNOp("Conv", "conv1", ["input", "w1", "b1"], ["c1"], conv,
                (1, 1, 4, 4), s),
           NNOp("Relu", "relu1", ["c1"], ["r1"], {}, s, s),
           NNOp("Conv", "conv2", ["r1", "w2", "b2"], ["c2"], conv, s, s),
           NNOp("Relu", "relu2", ["c2"], ["r2"], {}, s, s),
           NNOp("Conv", "conv3", ["r2", "w3", "b3"], ["c3"], conv, s, s),
           NNOp("Add", "add", ["c3", "r1"], ["out"], {}, s, s)]
    return NNGraph(ops, w, "input", (1, 1, 4, 4), "out")


def _port_graph(g):
    return interop.nngraph([dataclasses.asdict(op) for op in g.ops],
                           g.weights, g.input_name, g.input_shape,
                           g.output_name)


def _cfg(mod):
    return mod.SchemeConfig(security_level=0, hamming_weight=16,
                            first_mod_size=50, scaling_mod_size=40,
                            relu_value_range=4.0, relu_mul_depth=9,
                            use_bootstrap=False)


def test_prefix_pattern_bit_exact_and_decodes():
    g = _prefix_graph()
    model = M.compile_model(g, _cfg(S), num_classes=OUT_LEN)
    x = RNG.uniform(-1, 1, (1, 4, 4))
    ct = model.ctx.prepare_input(x, "input", level=model.scheme.input_level)
    want = model.runner.run(ct)

    tg = _port_graph(g)
    tctx = TFheContext(scheme_info=model.scheme, device="cpu")
    tkg = port_keygen(tctx.params, model.ctx.keygen,
                      rng=np.random.default_rng(1))
    tctx.keygen = tctx.evaluator.keygen = tkg
    tmodel = TM.compile_model(tg, _cfg(TS), ctx=tctx, num_classes=OUT_LEN)
    assert dataclasses.asdict(tmodel.scheme) == \
        dataclasses.asdict(model.scheme)
    got = tmodel.runner.run(port_ct(ct))
    assert_ct_equal(got, want)

    plain = TM.infer_plain(tg, x, n_slots=model.scheme.poly_degree // 2)
    dec = TM.infer_encrypted(tmodel, x)
    assert dec.shape == (OUT_LEN,)
    assert np.max(np.abs(dec - plain[:OUT_LEN])) < 5e-2


def test_resnet20_params_that_chip_smoke_uses():
    """ResNet-20 at run_resnet.py's settings selects N=2^15, L=33 with
    3 digits; its first residual block without bootstrapping needs 29
    levels in both packages."""
    g = M.build_resnet_cifar(3)
    vr_default, vr = ranges_for("resnet20_cifar10")
    kw = dict(security_level=0, hamming_weight=192, first_mod_size=60,
              scaling_mod_size=56, relu_mul_depth=9,
              relu_value_range=vr_default, relu_ranges=vr)
    info = select_params(g, SchemeConfig(**kw, use_bootstrap=True))
    assert (info.poly_degree, info.mul_level, info.q_part_num,
            info.p_prime_num) == (32768, 33, 3, 11)
    g.ops = g.ops[:6]
    g.output_name = g.ops[-1].outputs[0]
    assert g.output_name == "/layer1/layer1.0/Add_output_0"
    want = select_params(g, SchemeConfig(**kw, use_bootstrap=False))
    tg = TM.build_resnet_cifar(3)
    tg.ops = tg.ops[:6]
    tg.output_name = tg.ops[-1].outputs[0]
    got = TS.select_params(tg, TS.SchemeConfig(**kw, use_bootstrap=False))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.poly_degree, got.mul_level) == (32768, 29)


def test_resnet20_weights_equal():
    g, tg = M.build_resnet_cifar(3), TM.build_resnet_cifar(3)
    assert [dataclasses.asdict(o) for o in g.ops] == \
        [dataclasses.asdict(o) for o in tg.ops]
    assert g.weights.keys() == tg.weights.keys()
    for k in g.weights:
        np.testing.assert_array_equal(tg.weights[k], g.weights[k],
                                      err_msg=k)


def test_compile_model_wires_bootstrap():
    """use_bootstrap=True: the graph runner's backend bootstraps through
    the context's FheContext.bootstrap before each ReLU."""
    model = TM.compile_model(_port_graph(_prefix_graph()),
                             TS.SchemeConfig(security_level=0,
                                             hamming_weight=16),
                             device="cpu")
    assert model.runner.bootstrap_before_relu
    assert model.runner.be.bootstrap_fn == model.ctx.bootstrap


def test_resnet20_bootstrap_params_equal():
    """All of ResNet-20 with bootstrapping (chip_smoke.py phase 6): the
    port's select_params equals ace_tpu's, the port's level_sim
    resolving bootstrap_depth through its own ckks.bootstrap."""
    vr_default, vr = ranges_for("resnet20_cifar10")
    kw = dict(security_level=0, hamming_weight=192, first_mod_size=60,
              scaling_mod_size=56, relu_mul_depth=9,
              relu_value_range=vr_default, relu_ranges=vr,
              use_bootstrap=True)
    want = select_params(M.build_resnet_cifar(3), SchemeConfig(**kw))
    got = TS.select_params(TM.build_resnet_cifar(3), TS.SchemeConfig(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.poly_degree, got.mul_level, got.input_level,
            got.bootstrap_depth) == (32768, 33, want.input_level, 15)


def _tiny_cnn_cfg(mod):
    """tests/test_e2e_tiny.py's encrypted configuration: degree 64, a
    bootstrap before the ReLU."""
    return mod.SchemeConfig(security_level=0, hamming_weight=32,
                            relu_value_range=2.0, relu_mul_depth=13)


def test_tiny_cnn_bootstrap_bit_exact_and_decodes():
    """tests/test_e2e_tiny.py's CNN (Conv -> ReLU -> GlobalAveragePool on
    4x4, degree 64) with a bootstrap before its ReLU, through both
    packages on the same keys and the same input ciphertext: equal
    residues. Then the port alone, end to end through infer_encrypted:
    decoded within test_e2e_tiny.py's 5e-2 of infer_plain."""
    from tests.test_e2e_tiny import tiny_cnn
    g = tiny_cnn()
    model = M.compile_model(g, _tiny_cnn_cfg(S), num_classes=2)
    assert model.scheme.poly_degree == 64
    x = RNG.uniform(-1, 1, (1, 4, 4))
    ct = model.ctx.prepare_input(x, "input", level=model.scheme.input_level)
    want = model.runner.run(ct)

    tg = _port_graph(g)
    tctx = TFheContext(scheme_info=model.scheme, device="cpu")
    tkg = port_keygen(tctx.params, model.ctx.keygen,
                      rng=np.random.default_rng(3))
    tctx.keygen = tctx.evaluator.keygen = tkg
    tmodel = TM.compile_model(tg, _tiny_cnn_cfg(TS), ctx=tctx, num_classes=2)
    assert dataclasses.asdict(tmodel.scheme) == \
        dataclasses.asdict(model.scheme)
    got = tmodel.runner.run(port_ct(ct))
    assert_ct_equal(got, want)

    plain = TM.infer_plain(tg, x, n_slots=32)[:2]
    dec = TM.infer_encrypted(tmodel, x)
    assert dec.shape == (2,)
    assert np.max(np.abs(dec - plain)) < 5e-2, (dec, plain)
