"""The scheme of a configuration as port.Program hands it to the program:
the seven required keys with their meaning, every further field of
SchemeConfig as the configuration states it, and any other key refused
by name before anything is compiled. The compile is stubbed down to
what `Program.ring()` reads: the program's own select_params and the
CRT context it builds from it, no keys and no evaluator."""

import dataclasses
import types

import pytest
import torch

from fhb_util import stem_cell
from fhebench import cells, control, port, run

CONFIGS = [c["name"] for c in cells.benchmark()["configs"]]


@pytest.fixture
def compiled(monkeypatch):
    """The SchemeConfigs that resnet.compile_model receives, in order."""
    from ace_tpu_torch.compiler.scheme_info import select_params
    from ace_tpu_torch.models import resnet
    from ace_tpu_torch.poly.rns import CrtContext
    got = []

    def compile_model(graph, cfg, num_classes, device):
        got.append(cfg)
        si = select_params(graph, cfg)
        crt = CrtContext(si.mul_level + 1, si.first_mod_size,
                         si.scaling_mod_size, si.poly_degree,
                         si.q_part_num, device)
        return types.SimpleNamespace(
            scheme=si, ctx=types.SimpleNamespace(
                device=torch.device(device),
                params=types.SimpleNamespace(crt=crt)))

    monkeypatch.setattr(resnet, "compile_model", compile_model)
    return got


def _as_the_parent_built_it(scheme, graph, calibration):
    """SchemeConfig from the seven keys by name, as the harness built it
    before a configuration could state further fields."""
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import SchemeConfig
    from ace_tpu_torch.models import resnet
    vr_default, vr = ranges_for(scheme["relu_ranges"])
    vr_default, vr = resnet.calibrate_relu_ranges(graph, calibration,
                                                  vr_default, vr)
    return SchemeConfig(
        security_level=scheme["security_level"],
        hamming_weight=scheme["hamming_weight"],
        first_mod_size=scheme["first_mod_size"],
        scaling_mod_size=scheme["scaling_mod_size"],
        relu_mul_depth=scheme["relu_mul_depth"],
        relu_value_range=vr_default, relu_ranges=vr,
        use_bootstrap=scheme["use_bootstrap"])


def _calibration(cell):
    """The calibration images run.setup draws."""
    from fhebench import model
    cfg = cell.config
    arch, cal = cfg["architecture"], cfg["calibration"]
    gen = torch.Generator().manual_seed(cal["seed"])
    return model.draw_images(gen, cal["images"], arch["image"], cal["low"],
                             cal["high"], "cpu").numpy()


@pytest.mark.parametrize("name", CONFIGS)
def test_each_config_builds_the_same_scheme_and_ring(compiled, name):
    cell = types.SimpleNamespace(config=cells.config(name))
    # run.setup raises where the selected ring is not the configuration's
    _, _, prog = run.setup(cell, "cpu")
    assert prog.ring() == cell.config["ring"]
    (cfg,) = compiled
    want = _as_the_parent_built_it(cell.config["scheme"], prog.graph,
                                   _calibration(cell))
    assert type(cfg) is type(want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_a_further_field_reaches_the_scheme(compiled, monkeypatch):
    from ace_tpu_torch.compiler.scheme_info import SchemeConfig

    @dataclasses.dataclass
    class WithDegree(SchemeConfig):
        ring_degree: int = 0

    monkeypatch.setattr(port, "SchemeConfig", WithDegree)
    cell = stem_cell()
    scheme = dict(cell.config["scheme"], ring_degree=65536)
    run.setup(cell, "cpu", scheme)
    (cfg,) = compiled
    assert type(cfg) is WithDegree and cfg.ring_degree == 65536
    assert cfg.first_mod_size == scheme["first_mod_size"]


@pytest.mark.parametrize("key,value", [("q0", 51), ("sec_level", 0),
                                       ("relu_value_range", 3.0)])
def test_a_key_that_is_no_option_is_refused_before_compile(
        compiled, key, value):
    """A key that names no field of SchemeConfig, and relu_value_range,
    which the table that relu_ranges names gives."""
    cell = stem_cell()
    with pytest.raises(ValueError, match=repr(key)):
        run.setup(cell, "cpu", dict(cell.config["scheme"], **{key: value}))
    assert compiled == []


@pytest.mark.parametrize("key", port.REQUIRED)
def test_a_required_key_is_required(compiled, key):
    cell = stem_cell()
    scheme = dict(cell.config["scheme"])
    del scheme[key]
    with pytest.raises(KeyError, match=key):
        run.setup(cell, "cpu", scheme)
    assert compiled == []


def test_a_control_changes_a_further_field():
    scheme = dict(stem_cell().config["scheme"], ring_degree=65536)
    out = control._scheme(scheme, "ring_degree=32768,first_mod_size=59")
    assert out == dict(scheme, ring_degree=32768, first_mod_size=59)
    with pytest.raises(KeyError):
        control._scheme(scheme, "q0=59")
