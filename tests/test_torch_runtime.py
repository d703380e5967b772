"""PyTorch port: runtime services against ace_tpu's — the weight file
(rt_data: byte-identical files, each package reading the other's, the
plaintext manager equal to a direct encode), the native async block
loader, run-time validation (ValidatingBackend, --rtt) and checkpoint
resume, within the port and across the packages in both directions."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ace_tpu.ckks.params import CkksParams
from ace_tpu.compiler import packing as pk
from ace_tpu.compiler.lowering import GraphRunner
from ace_tpu.compiler.onnx_front import NNGraph, NNOp
from ace_tpu.compiler.scheme_info import SchemeConfig
from ace_tpu.models import resnet as M
from ace_tpu.runtime import rt_data
from ace_tpu.runtime.context import FheContext
from ace_tpu.runtime.validate import Shadow, ValidatingBackend
from ace_tpu_torch import interop
from ace_tpu_torch.ckks.params import CkksParams as TParams
from ace_tpu_torch.compiler import packing as tpk
from ace_tpu_torch.compiler.lowering import GraphRunner as TGraphRunner
from ace_tpu_torch.compiler.scheme_info import SchemeConfig as TSchemeConfig
from ace_tpu_torch.models import resnet as TM
from ace_tpu_torch.runtime import ckpt as tckpt
from ace_tpu_torch.runtime import rt_data as trt
from ace_tpu_torch.runtime.block_io import AsyncBlockLoader
from ace_tpu_torch.runtime.context import FheContext as TFheContext
from ace_tpu_torch.runtime.validate import Shadow as TShadow
from ace_tpu_torch.runtime.validate import ValidationError

from tests.torch_port_util import (CPU, arr, assert_ct_equal,
                                   assert_poly_equal, port_ct, port_keygen)

RNG = np.random.default_rng(71)
KW = dict(degree=32, num_q=6, first_mod_size=33, scaling_mod_size=30)


@pytest.fixture(scope="module")
def pair():
    """ace_tpu's context and the port's on the CPU, same parameters."""
    return (FheContext(CkksParams(**KW), seed=9),
            TFheContext(TParams(**KW, device="cpu"), seed=9))


# -- weight file ------------------------------------------------------------

def _write(mod, path, pt_data):
    w = mod.RtDataWriter()
    w.append("conv1_weight", np.linspace(-1, 1, 37).astype(np.float32))
    w.append_f64("fc_bias", np.linspace(-2, 2, 8))
    w.append_pt("encoded_w", pt_data, scale=2.0**30, sf_degree=1, level=3,
                msg_len=8)
    w.write(path)


def test_rt_data_files_byte_identical_and_cross_read(tmp_path):
    pt_data = RNG.integers(0, 2**60, (3, 32), dtype=np.uint64)
    paths = {m.__name__: str(tmp_path / f"{i}.msg")
             for i, m in enumerate((rt_data, trt))}
    for mod in (rt_data, trt):
        _write(mod, paths[mod.__name__], pt_data)
    blobs = [open(p, "rb").read() for p in paths.values()]
    assert blobs[0] == blobs[1]
    for reader_mod in (rt_data, trt):
        for path in paths.values():
            r = reader_mod.RtDataReader(path)
            assert [e["name"] for e in r.entries] == \
                ["conv1_weight", "fc_bias", "encoded_w"]
            ent, a = r.read(r.by_name["conv1_weight"])
            assert ent["kind"] == trt.KIND_F32 and a.dtype == np.float32
            np.testing.assert_array_equal(a, np.linspace(-1, 1, 37)
                                          .astype(np.float32))
            np.testing.assert_array_equal(r.read(1)[1],
                                          np.linspace(-2, 2, 8))
            ent, a = r.read(r.by_name["encoded_w"])
            assert (ent["level"], ent["scale"]) == (3, 2.0**30)
            np.testing.assert_array_equal(a.reshape(3, 32), pt_data)
            r.prefetch(0)
            r.close()


def test_pt_manager_equals_encode(tmp_path, pair):
    """An f32 entry decodes to the port encoder's encode of the same
    values (and to ace_tpu's manager), residue for residue; a pre-encoded
    entry lifts to the stored residues; a level mismatch raises."""
    ctx, tctx = pair
    vals = RNG.uniform(-1, 1, 12).astype(np.float32)
    pt = ctx.encoder.encode(np.asarray(vals, np.complex128), level=4)
    w = trt.RtDataWriter()
    w.append("w0", vals)
    w.append_pt("w_enc", arr(pt.poly), scale=pt.scaling_factor,
                sf_degree=pt.sf_degree, level=4, msg_len=12)
    path = str(tmp_path / "w.msg")
    w.write(path)
    mgr, tmgr = ctx.open_weight_file(path), tctx.open_weight_file(path)
    msg = np.zeros(KW["degree"] // 2, np.complex128)
    msg[:12] = vals
    for sf in (1, 2):
        got = tmgr.get("w0", level=4, sf_degree=sf)
        assert tmgr.get("w0", level=4, sf_degree=sf) is got  # cached
        assert_poly_equal(got.poly, mgr.get("w0", level=4,
                                            sf_degree=sf).poly)
        want = tctx.encoder.encode(msg, level=4, sf_degree=sf)
        assert torch.equal(got.poly.data, want.poly.data)
        assert got.scaling_factor == want.scaling_factor
    enc = tmgr.get("w_enc", level=4)
    assert enc.poly.data.device == tctx.device
    assert_poly_equal(enc.poly, pt.poly)
    assert (enc.scaling_factor, enc.sf_degree, enc.slots) == \
        (pt.scaling_factor, pt.sf_degree, 12)
    with pytest.raises(ValueError, match="re-run compile-time encoding"):
        tmgr.get("w_enc", level=3)


@pytest.fixture
def data_file(tmp_path):
    w = trt.RtDataWriter()
    rng = np.random.default_rng(3)
    blobs = {f"w{i}": rng.standard_normal(100 + 7 * i).astype(np.float32)
             for i in range(5)}
    for name, a in blobs.items():
        w.append(name, a)
    path = str(tmp_path / "weights.bin")
    w.write(path)
    return path, blobs


def test_async_loader_roundtrip_and_short_read(data_file):
    path, blobs = data_file
    rd = trt.RtDataReader(path)
    aio = AsyncBlockLoader(path)
    assert aio.engine in ("io_uring", "threadpool")
    toks = {}
    for name in blobs:
        ent = rd.entries[rd.by_name[name]]
        toks[name] = aio.submit(ent["offset"], ent["nbytes"])
    for name in reversed(list(blobs)):  # out-of-order waits
        np.testing.assert_array_equal(
            aio.wait(toks[name]).view(np.float32), blobs[name])
    tok = aio.submit(os.path.getsize(path) - 10, 100)  # runs past EOF
    with pytest.raises(OSError, match="short read"):
        aio.wait(tok)
    aio.close()
    rd.close()
    with pytest.raises(OSError, match="bio_open failed"):
        AsyncBlockLoader(path + ".missing")


@pytest.mark.parametrize("async_io", [True, False])
def test_pt_manager_prefetch(data_file, async_io):
    path, blobs = data_file

    class FakeEncoder:
        class params:
            slots = 256

        def encode(self, msg, level=0, sf_degree=1):
            return np.asarray(msg)

    mgr = trt.PtManager(trt.RtDataReader(path), FakeEncoder(), path=path,
                        async_io=async_io)
    assert (mgr.bio_engine != "mmap") == async_io
    for name in blobs:
        mgr.prefetch(name)
    for name, a in blobs.items():
        got = mgr.get(name, level=3)
        np.testing.assert_array_equal(got[:a.size].real, a)
    assert not mgr._pending


# -- run-time validation ----------------------------------------------------

def _tiny_graph():
    """Conv(1->2, 3x3) -> Mul(0.5) -> Add(residual) on 4x4."""
    s = (1, 2, 4, 4)
    w = {"w1": RNG.uniform(-0.5, 0.5, (2, 1, 3, 3)),
         "b1": RNG.uniform(-0.1, 0.1, 2), "c": np.full(s, 0.5)}
    ops = [NNOp("Conv", "conv1", ["input", "w1", "b1"], ["c1"],
                {"strides": [1, 1], "pads": [1, 1, 1, 1]}, (1, 1, 4, 4), s),
           NNOp("Mul", "m1", ["c1", "c"], ["t1"], {}, s, s),
           NNOp("Add", "a1", ["t1", "c1"], ["out"], {}, s, s)]
    return NNGraph(ops, w, "input", (1, 1, 4, 4), "out")


def _port_graph(g):
    return interop.nngraph([dataclasses.asdict(op) for op in g.ops],
                           g.weights, g.input_name, g.input_shape,
                           g.output_name)


def test_validated_graph_matches_and_raises():
    """compile_model(check_every=True) in both packages on the same keys
    and input ciphertext: the same op-by-op validation trail, shadow
    message and output residues; then a perturbed ciphertext raises."""
    kw = dict(degree=64, num_q=6, first_mod_size=50, scaling_mod_size=40)
    g = _tiny_graph()
    ctx = FheContext(CkksParams(**kw), seed=5)
    model = M.compile_model(g, SchemeConfig(security_level=0,
                                            use_bootstrap=False),
                            ctx=ctx, num_classes=32, check_every=True)
    assert isinstance(model.runner.be, ValidatingBackend)
    x = RNG.uniform(-1, 1, 16)
    msg = np.zeros(32)
    msg[:16] = x
    ct = ctx.prepare_input(x, "input")
    trail = []
    model.runner.be.trace = trail.append
    want = model.runner.run(Shadow(ct, msg))

    tctx = TFheContext(TParams(**kw, device="cpu"), seed=5)
    tctx.keygen = tctx.evaluator.keygen = port_keygen(
        tctx.params, ctx.keygen, rng=np.random.default_rng(1))
    tmodel = TM.compile_model(_port_graph(g),
                              TSchemeConfig(security_level=0,
                                            use_bootstrap=False),
                              ctx=tctx, num_classes=32, check_every=True)
    tbe = tmodel.runner.be
    ttrail = []
    tbe.trace = ttrail.append
    got = tmodel.runner.run(TShadow(port_ct(ct), msg))
    assert len(ttrail) > 20 and ttrail == trail
    np.testing.assert_array_equal(got.msg, want.msg)
    assert_ct_equal(got.ct, want.ct)
    tbe.check(got, "output")
    bad = TShadow(tctx.evaluator.add_const(got.ct, 0.5), got.msg)
    with pytest.raises(ValidationError, match="max_err"):
        tbe.check(bad, "perturbed")
    with pytest.raises(ValidationError):
        tbe.add(bad, TShadow(got.ct, got.msg))


# -- checkpoint resume --------------------------------------------------------

def _ckpt_graph():
    """tests/test_ckpt.py's graph: the Add reads a value produced two
    ops earlier, so resume must restore more than the last output."""
    shape = (1, 1, 2, 4)
    ops = [NNOp("Mul", "m1", ["input", "c"], ["t1"], {}, shape, shape),
           NNOp("Mul", "m2", ["t1", "c"], ["t2"], {}, shape, shape),
           NNOp("Add", "a1", ["t2", "t1"], ["out"], {}, shape, shape)]
    return NNGraph(ops, {"c": np.full(shape, 0.5)}, "input", shape, "out")


def _first_op(g):
    return NNGraph(g.ops[:1], g.weights, g.input_name, g.input_shape,
                   g.ops[0].outputs[0])


def test_port_checkpoint_resumes_bit_exact(tmp_path, pair):
    _, tctx = pair
    g = _port_graph(_ckpt_graph())
    be = tpk.FheBackend(tctx.evaluator, tctx.encoder)
    img = np.arange(8) * 0.1 - 0.3
    x = tctx.prepare_input(img.reshape(1, 1, 2, 4), "input")
    full = TGraphRunner(g, be).run(x)
    ck = str(tmp_path / "ck.npz")
    TGraphRunner(_port_graph(_first_op(_ckpt_graph())), be).run(
        x, checkpoint=ck)
    env, nop = tckpt.load(ck, CPU)
    assert nop == 1 and set(env) == {"t1"}
    out = TGraphRunner(g, be).run(x, checkpoint=ck)
    assert torch.equal(out.c0.data, full.c0.data)
    assert torch.equal(out.c1.data, full.c1.data)
    tctx.set_output_data("o", out)
    np.testing.assert_allclose(tctx.handle_output("o", 8),
                               img * 0.25 + img * 0.5, atol=1e-3)


@pytest.mark.parametrize("writer", ["ace_tpu", "port"])
def test_checkpoint_crosses_packages(tmp_path, pair, writer):
    """A checkpoint written after op 1 by one package resumes in the
    other to ace_tpu's uninterrupted residues; both packages write the
    same arrays and metadata."""
    ctx, tctx = pair
    g, tg = _ckpt_graph(), _port_graph(_ckpt_graph())
    be = pk.FheBackend(ctx.evaluator, ctx.encoder)
    tbe = tpk.FheBackend(tctx.evaluator, tctx.encoder)
    img = np.arange(8) * 0.1 - 0.3
    x = ctx.prepare_input(img.reshape(1, 1, 2, 4), "input")
    want = GraphRunner(g, be).run(x)
    cks = {w: str(tmp_path / f"{w}.npz") for w in ("ace_tpu", "port")}
    GraphRunner(_first_op(g), be).run(x, checkpoint=cks["ace_tpu"])
    TGraphRunner(_first_op(tg), tbe).run(port_ct(x),
                                         checkpoint=cks["port"])
    with np.load(cks["ace_tpu"]) as a, np.load(cks["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    if writer == "ace_tpu":
        got = TGraphRunner(tg, tbe).run(port_ct(x), checkpoint=cks[writer])
        assert_ct_equal(got, want)
    else:
        got = GraphRunner(g, be).run(x, checkpoint=cks[writer])
        np.testing.assert_array_equal(arr(got.c0), arr(want.c0))
        np.testing.assert_array_equal(arr(got.c1), arr(want.c1))
