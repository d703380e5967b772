"""The MAC bundles' kept message stacks (Evaluator.kept_msgs).

A compiled graph's convs (FheBackend.rot_ext_mac_groups inside the graph
runner's call sites) and a bootstrap's BSGS levels
(BootstrapContext._transform) build each [G, R, N] message stack at the
call site's first run and reuse it after: the residues equal those of
the path that encodes every diagonal on every call, the second call
encodes and hashes no message, no message row is held beside the kept
stacks, and a second compile_model keeps its own stacks. On the CPU at
N = 64.
"""

from __future__ import annotations

import gc
import hashlib

import numpy as np
import pytest
import torch

from ace_tpu_torch.compiler import packing as pk
from ace_tpu_torch.compiler.onnx_front import NNGraph, NNOp
from ace_tpu_torch.compiler.scheme_info import SchemeConfig
from ace_tpu_torch.models import resnet as TM

CONV = {"dilations": [1, 1], "group": 1, "kernel_shape": [3, 3],
        "pads": [1, 1, 1, 1], "strides": [1, 1]}


def _graph(seed: int, relu: bool = True) -> NNGraph:
    """Conv 1 -> 2 channels on 4x4, a ReLU (bootstrapped), then a stride-2
    Conv 2 -> 2 (its compaction adds MAC bundles to the op)."""
    rng = np.random.default_rng(seed)
    w = {"w1": rng.uniform(-0.5, 0.5, (2, 1, 3, 3)),
         "b1": rng.uniform(-0.1, 0.1, 2),
         "w2": rng.uniform(-0.3, 0.3, (2, 2, 3, 3)),
         "b2": rng.uniform(-0.1, 0.1, 2)}
    s1, s2 = (1, 2, 4, 4), (1, 2, 2, 2)
    ops = [NNOp("Conv", "conv1", ["input", "w1", "b1"], ["c1"], CONV,
                (1, 1, 4, 4), s1)]
    mid = "c1"
    if relu:
        ops.append(NNOp("Relu", "relu1", ["c1"], ["r1"], {}, s1, s1))
        mid = "r1"
    ops.append(NNOp("Conv", "conv2", [mid, "w2", "b2"], ["out"],
                    dict(CONV, strides=[2, 2]), s1, s2))
    return NNGraph(ops, w, "input", (1, 1, 4, 4), "out")


IMG = np.random.default_rng(5).uniform(-1, 1, (1, 4, 4))


def _compile(g: NNGraph, ctx=None):
    vr_default, vr = TM.calibrate_relu_ranges(g, [IMG], 4.0, {})
    cfg = SchemeConfig(security_level=0, hamming_weight=16,
                       first_mod_size=50, scaling_mod_size=40,
                       relu_mul_depth=9, relu_value_range=vr_default,
                       relu_ranges=vr, use_bootstrap=True)
    return TM.compile_model(g, cfg, ctx=ctx, num_classes=8, device="cpu")


class _Spy:
    """Counts the encoder's message encodes, its cached plaintext encodes
    (a bias's add_plain, a mask's mul_plain) and BLAKE2b digests."""

    def __init__(self, monkeypatch, enc):
        self.calls = dict(encode_msg=0, encode_cached=0, blake2b=0)
        for name in ("encode_msg", "encode_cached"):
            monkeypatch.setattr(enc, name, self._counted(
                name, getattr(enc, name)))
        monkeypatch.setattr(hashlib, "blake2b", self._counted(
            "blake2b", hashlib.blake2b))

    def _counted(self, name, fn):
        def wrapper(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    def take(self) -> dict:
        out = dict(self.calls)
        self.calls = dict.fromkeys(self.calls, 0)
        return out


def _unkept(mp, ev):
    """The path without kept stacks: the graph runner opens no call site,
    so each conv builds its stack on every call, and so does every BSGS
    level."""
    mp.delattr(pk.FheBackend, "call_site")
    mp.setattr(ev, "kept_msgs", lambda memo, key, build: build())


def _equal(a, b) -> bool:
    return torch.equal(a.c0.data, b.c0.data) and \
        torch.equal(a.c1.data, b.c1.data)


def _stacks(ev) -> tuple:
    st = ev.program_stats()
    return st["stacks_built"], st["stacks_reused"]


def _message_rows(n: int) -> int:
    """Live [N] int64 tensors: single messages held apart from a stack
    (a kept stack's rows are views of it, not tensors of their own)."""
    gc.collect()
    return sum(1 for o in gc.get_objects() if type(o) is torch.Tensor
               and o.dtype == torch.int64 and tuple(o.shape) == (n,))


def test_graph_stacks_built_once_bit_identical(monkeypatch):
    m = _compile(_graph(7))
    ev, enc = m.ctx.evaluator, m.ctx.encoder
    x = m.ctx.prepare_input(IMG, "input", level=m.scheme.input_level)
    with monkeypatch.context() as mp:
        _unkept(mp, ev)
        want = m.runner.run(x)
    assert _stacks(ev) == (0, 0)
    rows = _message_rows(m.ctx.params.degree)

    spy = _Spy(monkeypatch, enc)
    first = m.runner.run(x)
    sites = len(m.runner._msg_stacks)
    levels = len(m.ctx.bootstrap_precom()._msg_stacks)
    assert sites >= 3 and levels >= 2  # conv1; conv2 and its compaction
    assert _stacks(ev) == (sites + levels, 0)
    assert spy.take()["encode_msg"] > sites + levels

    second = m.runner.run(x)
    assert _stacks(ev) == (sites + levels, sites + levels)
    # the only digests left are the plaintexts' (biases, masks), none of
    # a MAC bundle's message
    calls = spy.take()
    assert calls["encode_msg"] == 0
    assert calls["blake2b"] == calls["encode_cached"]
    del spy
    assert _message_rows(m.ctx.params.degree) == rows
    assert _equal(first, want) and _equal(second, want)
    assert "message stacks: %d built, %d reused" % _stacks(ev) \
        in m.ctx.finalize()


@pytest.mark.parametrize("encoding", [True, False], ids=["c2s", "s2c"])
def test_bootstrap_transform_stacks_kept(monkeypatch, encoding):
    m = _compile(_graph(7, relu=False))
    ev, enc = m.ctx.evaluator, m.ctx.encoder
    bts = m.ctx.bootstrap_precom()
    ct = m.ctx.prepare_input(IMG, "input")
    with monkeypatch.context() as mp:
        _unkept(mp, ev)
        want = bts._transform(ct, encoding)
    assert _stacks(ev) == (0, 0) and not bts._msg_stacks

    spy = _Spy(monkeypatch, enc)
    first = bts._transform(ct, encoding)
    levels = len(bts._msg_stacks)
    assert levels >= 2 and _stacks(ev) == (levels, 0)
    assert spy.take()["encode_msg"] > 0
    second = bts._transform(ct, encoding)
    assert _stacks(ev) == (levels, levels)
    assert not any(spy.take().values())
    assert _equal(first, want) and _equal(second, want)


def test_second_compile_keeps_its_own_stacks(monkeypatch):
    """A second compile_model on the same context (other weights, the
    same call sites) builds its own stacks, and its residues are those of
    its un-kept path, not the first model's."""
    a = _compile(_graph(7, relu=False))
    ctx = a.ctx
    x = ctx.prepare_input(IMG, "input", level=a.scheme.input_level)
    out_a = a.runner.run(x)
    built = _stacks(ctx.evaluator)[0]
    assert built == len(a.runner._msg_stacks) > 0

    b = _compile(_graph(8, relu=False), ctx=ctx)
    assert b.runner._msg_stacks == {}
    with monkeypatch.context() as mp:
        _unkept(mp, ctx.evaluator)
        want = b.runner.run(x)
    out_b = b.runner.run(x)
    assert _stacks(ctx.evaluator) == (2 * built, 0)
    assert set(b.runner._msg_stacks) == set(a.runner._msg_stacks)
    assert _equal(out_b, want) and not _equal(out_b, out_a)
