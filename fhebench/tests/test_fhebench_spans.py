"""The readers of the program's own spans (fhebench/spans.py and the
metrics that use it) on a fake run: each share sums the device seconds
of its recorded spans, counted once where they nest, over the profiled
seconds; set-up seconds are the device seconds of the program's set-up
regions; without a card, or with a program that keeps no span records,
they read nothing."""

import types

import pytest

import fhb_util  # noqa: F401  (the repository on the path)
from fhebench import cells, spans


def _rec(name, device_s, parent=None, keyswitch=False):
    return types.SimpleNamespace(name=name, device_s=device_s,
                                 parent=parent, keyswitch=keyswitch)


def _records():
    """Two bootstraps with their stages, a conv whose rotation bundle
    recurses, a ReLU, and a ReLU the card has not passed yet."""
    out = []
    for _ in range(2):
        b = _rec("RTM_BOOTSTRAP", 0.8)
        out += [b, _rec("RTM_BS_COEFF_TO_SLOT", 0.2, b),
                _rec("RTM_BS_APPROX_MOD", 0.3, b),
                _rec("RTM_BS_APPROX_MOD", 0.1, b),
                _rec("RTM_BS_SLOT_TO_COEFF", 0.1, b)]
        out.append(_rec("CKKS::conjugate", 0.05, b, keyswitch=True))
    conv = _rec("Tensor::conv", 0.6)
    bundle = _rec("CKKS::rot_mac_groups_msgs_jit", 0.5, conv, True)
    out += [conv, bundle,
            _rec("CKKS::rot_mac_groups_msgs_jit", 0.2, bundle, True),
            _rec("CKKS::add", 0.01, bundle)]
    relu = _rec("RTM_RELU", 0.4)
    out += [relu, _rec("CKKS::mul", 0.1, relu, keyswitch=True),
            _rec("RTM_RELU", None)]
    return out


class _Timing:
    def __init__(self, records, device_seconds):
        self._records, self._dev = records, device_seconds

    def records(self):
        return list(self._records)

    def seconds(self, name):
        """Host seconds: the enqueue alone, which no reader takes."""
        return self._dev.get(name, 0.0) / 10

    def device_seconds(self, name):
        return self._dev.get(name, 0.0)


def _run(cuda=True, window=4.0):
    return types.SimpleNamespace(cuda=cuda, trace_window_s=window,
                                 programs={"capture_s": 12.5})


@pytest.fixture
def program(monkeypatch):
    t = _Timing(_records(), {"RTM_KEYGEN": 41.0, "RTM_PT_ENCODE": 9.5})
    monkeypatch.setattr(spans, "timing", lambda: t)
    return t


@pytest.mark.parametrize("metric,want", [
    ("bootstrap.share", 100 * 1.6 / 4),
    ("bootstrap.c2s.share", 100 * 0.4 / 4),
    ("bootstrap.evalmod.share", 100 * 0.8 / 4),
    ("bootstrap.s2c.share", 100 * 0.2 / 4),
    ("relu.share", 100 * 0.4 / 4),
    ("conv.share", 100 * 0.6 / 4),
    # the outer bundle once, the conjugates and the relinearization
    ("keyswitch.share", 100 * (0.1 + 0.5 + 0.1) / 4),
    ("setup.keygen_s", 41.0),
    ("setup.encode_s", 9.5),
    ("setup.capture_s", 12.5)])
def test_reader_on_a_fake_run(program, metric, want):
    assert cells.reader(metric)(_run()) == pytest.approx(want)


NEW = ["bootstrap.share", "bootstrap.c2s.share", "bootstrap.evalmod.share",
       "bootstrap.s2c.share", "relu.share", "conv.share", "keyswitch.share",
       "setup.keygen_s", "setup.encode_s", "setup.capture_s"]


@pytest.mark.parametrize("metric", NEW)
def test_without_a_card_nothing(program, metric):
    assert cells.reader(metric)(_run(cuda=False)) is None


@pytest.mark.parametrize("metric", NEW[:-1])
def test_a_program_without_span_records_gives_nothing(monkeypatch, metric):
    """The parent of the span system: its TIMING has no records, so the
    readers report nothing and do not raise."""
    monkeypatch.setattr(spans, "timing", lambda: None)
    assert cells.reader(metric)(_run()) is None


def test_the_program_keeps_span_records():
    from ace_tpu_torch.runtime.timing import TIMING
    assert spans.timing() is TIMING


def test_stage_shares_within_the_bootstraps(program):
    run = _run()
    stages = sum(cells.reader(m)(run) for m in (
        "bootstrap.c2s.share", "bootstrap.evalmod.share",
        "bootstrap.s2c.share"))
    assert stages <= cells.reader("bootstrap.share")(run) <= 100
