"""PyTorch port: the span system of runtime/timing.py on the CPU. Spans
off cost a flag check and touch neither the profiler nor the card; under
a torch.profiler session they record and nest as the code does (a
small-ring bootstrap's stages inside RTM_BOOTSTRAP, each image's spans
inside its RTM_INFER); with TIMING.enabled they count on the host clock;
a profiler stopped or started inside a span drops it; set-up regions
count, and time themselves on the card, with spans off; the readers of
snapshot() and report() keep their shapes."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.compiler.scheme_info import SchemeConfig
from ace_tpu_torch.models import resnet as TM
from ace_tpu_torch.runtime import timing
from ace_tpu_torch.runtime.context import FheContext
from ace_tpu_torch.runtime.timing import TIMING

from tests.test_torch_driver import _block_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(degree=16, num_q=3, first_mod_size=33, scaling_mod_size=30,
          device="cpu")
STAGES = ("RTM_BS_COEFF_TO_SLOT", "RTM_BS_APPROX_MOD",
          "RTM_BS_SLOT_TO_COEFF")
KEYSWITCH = {"CKKS::" + k for k in (
    "mul", "rotate", "conjugate", "rotations_hoisted", "rot_sum_jit",
    "rot_ext_mac_groups_jit", "rot_mac_groups_msgs_jit", "bsgs_iter_jit")}


@pytest.fixture
def spans(monkeypatch):
    """TIMING off and empty, restored after the test."""
    monkeypatch.setattr(TIMING, "enabled", False)
    TIMING.reset()
    yield TIMING
    TIMING.reset()


@pytest.fixture(scope="module")
def ctx():
    return FheContext(CkksParams(**KW), seed=5)


def _ct(ctx):
    msg = np.arange(ctx.params.degree // 2) / 16.0
    return ctx.evaluator.encrypt(ctx.encoder.encode(msg))


@pytest.fixture(scope="module")
def model():
    """The block graph (two bootstrapped ReLUs) at N = 64, image 0 run
    once so that its keys are made."""
    g = _block_graph()
    img = np.random.default_rng(3).uniform(-1, 1, (1, 4, 4))
    vd, vr = TM.calibrate_relu_ranges(g, [img], 4.0, {})
    cfg = SchemeConfig(security_level=0, hamming_weight=16,
                       first_mod_size=50, scaling_mod_size=40,
                       relu_mul_depth=9, relu_value_range=vd,
                       relu_ranges=vr, use_bootstrap=True)
    m = TM.compile_model(g, cfg, num_classes=4, device="cpu")
    TM.infer_encrypted(m, img)
    return m, img


def _raise(*a, **k):
    raise AssertionError("the profiler or the card was touched")


class _Event:
    """A CUDA event the card has passed, 1 ms after the one before."""

    def record(self, stream):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 1.0


def _on_a_card(spans, monkeypatch, event=_raise):
    """The card as the spans see it: CUDA in use, no capture, and
    torch.cuda.Event replaced by `event`."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(spans, "_stream", lambda: None)
    monkeypatch.setattr(spans, "_free", [])


def _op_rotate(ctx, ct):
    ctx.evaluator.rotate(ct, 1)


def _op_mul(ctx, ct):
    ctx.evaluator.rescale(ctx.evaluator.mul(ct, ct))


def _op_region(ctx, ct):
    with TIMING.tm("RTM_MAIN_GRAPH"):
        ctx.evaluator.add(ct, ct)


def _op_setup(ctx, ct):
    with TIMING.tm("RTM_BS_SETUP", setup=True):
        ctx.encoder.encode_msg(np.ones(4), slots=4)


@pytest.mark.parametrize("op,events", [(_op_rotate, 0), (_op_mul, 0),
                                       (_op_region, 0), (_op_setup, 4)],
                         ids=["rotate", "mul", "region", "setup"])
def test_spans_off_touch_neither_profiler_nor_card(spans, ctx, monkeypatch,
                                                   op, events):
    """With spans off, an op opens no annotation, makes no CUDA event and
    keeps no record, even where a card is in use; only a set-up region
    times itself on the card, by two CUDA events (RTM_BS_SETUP and the
    encode inside it). Recorded, the same op reaches the profiler (the
    patches are where the spans look)."""
    ct = _ct(ctx)
    ctx.keygen.rot_key(1)       # a set-up region of its own
    made = []
    _on_a_card(spans, monkeypatch,
               lambda **kw: made.append(kw) or _Event())
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    op(ctx, ct)
    assert len(made) == events and all(kw == {"enable_timing": True}
                                       for kw in made)
    assert spans.records() == [] and spans.dropped == 0
    if events:
        assert spans.device_seconds("RTM_BS_SETUP") == pytest.approx(1e-3)
    monkeypatch.setattr(timing, "_profiling", lambda: True)
    with pytest.raises(AssertionError, match="was touched"):
        op(ctx, ct)


def test_elementwise_ops_are_timed_on_the_host_alone(spans, ctx):
    """add, sub and the scalar ops open no span of their own, even under
    a profiler: their time, host and device, is the enclosing span's own
    (self_s); the ops around them record."""
    ct = ctx.evaluator.encrypt(ctx.encoder.encode(np.ones(4), slots=4))
    ev = ctx.evaluator
    with profile(activities=[ProfilerActivity.CPU]):
        with TIMING.tm("RTM_MAIN_GRAPH"):
            x = ev.mul_integer(
                ev.mul_const(ev.negate(ev.sub(ev.add(ct, ct), ct)), 0.5), 3)
            ev.rescale(x)
    rescale, outer = spans.records()
    assert (rescale.name, outer.name) == ("CKKS::rescale", "RTM_MAIN_GRAPH")
    assert rescale.parent is outer
    assert outer.self_s == pytest.approx(outer.device_s - rescale.device_s)
    assert outer.self_s > 0


def test_enabled_alone_turns_spans_on(spans, ctx, monkeypatch):
    """TIMING.enabled counts every span, its count and host seconds, with
    no profiler's annotation, no record and no CUDA event but those of
    the set-up regions; report() gives those regions' device seconds (on
    the CPU, their host seconds)."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    spans.enabled = True
    ct = _ct(ctx)
    _on_a_card(spans, monkeypatch)
    _op_mul(ctx, ct)
    assert spans.records() == []
    snap = spans.snapshot()
    assert set(snap) == {"RTM_PT_ENCODE", "CKKS::encrypt", "CKKS::mul",
                         "CKKS::rescale"}
    assert all(n == 1 and secs > 0 for n, secs in snap.values())
    monkeypatch.undo()
    rep = {ln.split()[1]: ln.split()[-1]
           for ln in spans.report().splitlines()[1:]}
    assert rep["CKKS::mul"] == "-"
    enc = spans.device_seconds("RTM_PT_ENCODE")
    assert enc == spans.seconds("RTM_PT_ENCODE") > 0
    assert rep["RTM_PT_ENCODE"] == f"{enc:.6f}"


def _ace(prof):
    """(name, start ns, end ns) of the profiler's ace/ regions on the
    host, from its raw events (prof.events() builds a tree over every
    ATen call: minutes here)."""
    return [(e.name()[4:], e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("ace/")]


def test_profiled_bootstrap_nests_its_stages(spans, model):
    """Under a CPU profiler, a bootstrap's ace/ regions nest as its code
    does: the mod raise, C2S, EvalMod and S2C inside RTM_BOOTSTRAP, on
    the profiler's clock and in the records, the stages summing to no
    more than their parent."""
    m, _ = model
    ctx = m.ctx
    slots = next(iter(ctx._bts))
    ct = ctx.evaluator.encrypt(ctx.encoder.encode(
        np.linspace(-0.5, 0.5, slots), level=3, slots=slots))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx.bootstrap(ct)
    regions = _ace(prof)
    names = {n for n, _, _ in regions}
    assert {"RTM_BOOTSTRAP", "RTM_BS_MOD_RAISE", "CKKS::bsgs_iter_jit",
            *STAGES} <= names
    (_, b0, b1), = [r for r in regions if r[0] == "RTM_BOOTSTRAP"]
    assert all(b0 <= s and e <= b1 for _, s, e in regions)
    recs = spans.records()
    assert sorted(r.name for r in recs) == sorted(n for n, _, _ in regions)
    assert spans.dropped == 0
    assert all(r.keyswitch == (r.name in KEYSWITCH) for r in recs)
    boot, = [r for r in recs if r.name == "RTM_BOOTSTRAP"]
    kids = [r for r in recs if r.parent is boot]
    assert {r.name for r in kids} >= {"RTM_BS_MOD_RAISE", *STAGES}
    staged = sum(r.device_s for r in kids if r.name in STAGES)
    assert 0 < staged <= boot.device_s
    timed = [r.device_s for r in kids if r.device_s is not None]
    assert boot.self_s == pytest.approx(boot.device_s - sum(timed))


def _root(rec):
    while rec.parent is not None:
        rec = rec.parent
    return rec


def test_image_spans_nest_and_carry_their_image(spans, model):
    """Under a profiler, each image's spans lead up to its own RTM_INFER;
    the graph runner's per-op spans hold the ReLU's polynomial and the
    bootstrap before it."""
    m, img = model
    with profile(activities=[ProfilerActivity.CPU]):
        TM.infer_encrypted(m, img)
        TM.infer_encrypted(m, img)
    recs = spans.records()
    roots = [r for r in recs if r.name == "RTM_INFER"]
    assert len(roots) == 2 and recs[-1] is roots[1]
    assert {id(_root(r)) for r in recs} == {id(r) for r in roots}
    for r in recs:
        root = _root(r)
        assert root.start <= r.start <= r.end <= root.end
    assert {"RTM_ENCODE_ARRAY", "RTM_MAIN_GRAPH", "Tensor::conv",
            "FHE::relu", "RTM_RELU", "RTM_BOOTSTRAP", "Tensor::add",
            "CKKS::encrypt", "CKKS::decrypt"} <= {r.name for r in recs}
    for r in recs:
        if r.name in ("RTM_RELU", "RTM_BOOTSTRAP"):
            assert r.parent.name == "FHE::relu"
        if r.name == "Tensor::conv":
            assert r.parent.name == "RTM_MAIN_GRAPH"


def _stop_inside(prof):
    prof.stop()


def _stop_and_restart_inside(prof):
    """Stopped, a span opened and closed with no profiler, started
    again: the outer span is dropped, and its annotation is not ended
    under the new session."""
    prof.stop()
    with TIMING.tm("between"):
        pass
    prof.start()


@pytest.mark.parametrize("change", [_stop_inside, _stop_and_restart_inside],
                         ids=["stopped", "stopped_and_restarted"])
def test_span_outliving_its_profiler_is_dropped(spans, change):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with TIMING.tm("outer"):
            with TIMING.tm("inner"):
                pass
            change(prof)
    finally:
        if torch._C._autograd._profiler_enabled():
            prof.stop()
    assert [r.name for r in spans.records()] == ["inner"]
    assert spans.dropped == 1
    assert spans.count("outer") == 0 and spans.count("inner") == 1


def test_profiler_started_inside_a_span(spans):
    """A span open when the profiler starts stays unrecorded; the spans
    opened after it record, with no parent."""
    prof = profile(activities=[ProfilerActivity.CPU])
    with TIMING.tm("outer"):
        prof.start()
        with TIMING.tm("inner"):
            pass
    prof.stop()
    recs = spans.records()
    assert [(r.name, r.parent) for r in recs] == [("inner", None)]
    assert spans.dropped == 0
    assert [n for n, _, _ in _ace(prof)] == ["inner"]


def test_setup_regions_count_with_spans_off(spans):
    """Key generation and encodes count with spans off, on the host clock
    and on the device stream (here the host's), and keep no record; a
    rotation key's RTM_KEYGEN holds the secret's image as well."""
    fresh = FheContext(CkksParams(**KW), seed=6)
    assert spans.count("RTM_PREPARE_CONTEXT") == 1
    assert spans.count("RTM_KEYGEN") == 1      # the relinearization key
    spans.reset()
    fresh.keygen.rot_key(3)
    fresh.encoder.encode(np.ones(4), slots=4)
    fresh.encoder.encode_msg(np.ones(4), slots=4)
    assert spans.count("RTM_ROT_KEY_REGEN") == 1
    assert spans.count("RTM_KEYGEN") == 1
    assert spans.count("RTM_PT_ENCODE") == 2
    assert spans.seconds("RTM_KEYGEN") > 0
    assert spans.device_seconds("RTM_KEYGEN") == spans.seconds("RTM_KEYGEN")
    assert (spans.device_seconds("RTM_KEYGEN")
            <= spans.device_seconds("RTM_ROT_KEY_REGEN"))
    assert spans.records() == []
    assert set(spans.snapshot()) == {"RTM_ROT_KEY_REGEN", "RTM_KEYGEN",
                                     "RTM_PT_ENCODE"}


def test_snapshot_and_report_keep_their_shape(spans, ctx):
    """scripts/torch_zoo.py and chip_smoke.py read snapshot() as {name:
    (count, host seconds)}, report() with or without counters."""
    ctx.keygen.rot_key(1)
    spans.reset()
    spans.enabled = True
    with TIMING.tm("RTM_BOOTSTRAP"):
        _op_rotate(ctx, _ct(ctx))
    snap = spans.snapshot()
    assert set(snap) == {"RTM_BOOTSTRAP", "RTM_PT_ENCODE", "CKKS::encrypt",
                         "CKKS::rotate"}
    for count, secs in snap.values():
        assert count == 1 and isinstance(secs, float) and secs > 0
    rep = spans.report().splitlines()
    assert rep[0] == "[RT_TIMING] name count total_sec device_sec"
    assert len(rep) == 5 and all(ln.startswith("[RT_TIMING] ")
                                 for ln in rep)
    boot = next(ln for ln in rep if "RTM_BOOTSTRAP" in ln).split()
    assert boot[2:4] == ["1", f"{snap['RTM_BOOTSTRAP'][1]:.6f}"]
    given = spans.report({"RTM_BOOTSTRAP": [2, 0.5]}).splitlines()
    assert given[1].split()[1:] == ["RTM_BOOTSTRAP", "2", "0.500000", "-"]


def test_every_level_name_is_recorded_by_the_port():
    """The report's level table names no span the port never opens."""
    src = ""
    for d, _, files in os.walk(os.path.join(REPO, "ace_tpu_torch")):
        src += "".join(open(os.path.join(d, f)).read() for f in files
                       if f.endswith(".py"))
    for name in timing.RTM_LEVELS:
        # once in the table, once where the span opens
        assert src.count(f'"{name}"') >= 2, name
