"""Declarative option groups with the reference CLI syntax.

The reference registers per-pass OPTION_DESC tables and parses
`-GRP:key=val:flag` strings (air-infra/include/air/util/option.h:54-234;
e.g. `-CKKS:sk_hw=192:q0=60:sf=56`, `-SIHE:relu_vr=/relu/Relu=4;...`,
`-P2C:lib=ant:fp`). This module parses the same surface into a
SchemeConfig + runtime settings so reference build scripts translate
1:1 onto the port's drivers (the `ace_tpu.utils.options` parser).
"""

from __future__ import annotations

import dataclasses

from ace_tpu_torch.compiler.scheme_info import SchemeConfig


@dataclasses.dataclass
class GlobalOptions:
    """The reference's global flags (global_config.h:21-52)."""
    trace: bool = False
    perf: bool = False
    show: bool = False
    output: str = ""


def parse_group(arg: str) -> tuple[str, dict]:
    """'-GRP:key=val:flag' -> ('GRP', {'key': 'val', 'flag': True})."""
    body = arg.lstrip("-")
    parts = body.split(":")
    group = parts[0]
    opts: dict = {}
    for p in parts[1:]:
        if not p:
            continue
        if "=" in p:
            k, v = p.split("=", 1)
            opts[k] = v
        else:
            opts[p] = True
    return group, opts


def parse_relu_vr(spec: str) -> dict:
    """-SIHE:relu_vr=<name>=<range>;<name>=<range> (sihe/src/config.cxx:24)."""
    out = {}
    for item in spec.split(";"):
        if not item:
            continue
        name, _, rng = item.rpartition("=")
        out[name] = float(rng)
    return out


_SEC_LEVELS = {"128": 128, "192": 192, "256": 256, "0": 0, "none": 0}


def parse_args(argv: list[str]) -> tuple[SchemeConfig, GlobalOptions, dict]:
    """Parse reference-style argv into (SchemeConfig, GlobalOptions,
    extras). Unknown groups/keys are collected in extras for the caller
    (mirrors OPTION_MGR's per-pass registration)."""
    cfg = SchemeConfig()
    glob = GlobalOptions()
    extras: dict = {}
    for arg in argv:
        if not arg.startswith("-"):
            extras.setdefault("inputs", []).append(arg)
            continue
        if arg in ("-trace", "--trace"):
            glob.trace = True
            continue
        if arg in ("-perf", "--perf"):
            glob.perf = True
            continue
        if arg in ("-show", "--show"):
            glob.show = True
            continue
        group, opts = parse_group(arg)
        if group == "CKKS":
            if "sk_hw" in opts:
                cfg.hamming_weight = int(opts["sk_hw"])
            if "q0" in opts:
                cfg.first_mod_size = int(opts["q0"])
            if "sf" in opts:
                cfg.scaling_mod_size = int(opts["sf"])
            if "sec" in opts:
                cfg.security_level = _SEC_LEVELS[str(opts["sec"])]
        elif group == "SIHE":
            if "relu_vr" in opts:
                cfg.relu_ranges = parse_relu_vr(str(opts["relu_vr"]))
            if "relu_vr_def" in opts:
                cfg.relu_value_range = float(opts["relu_vr_def"])
            if "relu_mul_depth" in opts or "relu_depth" in opts:
                cfg.relu_mul_depth = int(opts.get("relu_mul_depth")
                                         or opts.get("relu_depth"))
        elif group == "VEC":
            extras["vec"] = opts       # rtt / conv_fast toggles
        elif group == "P2C":
            extras["p2c"] = opts       # df=<weights file>, cte, fp
        else:
            extras[group] = opts
    return cfg, glob, extras
