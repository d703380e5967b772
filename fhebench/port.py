"""The system under test, as the benchmark drives it: the PyTorch port
`ace_tpu_torch`. Beside spans.py, which reads the program's span
records, this is the only module of the harness that imports the
program. It turns the harness's network and weights into the program's
graph, builds the program's SchemeConfig from the configuration's
`scheme`, compiles, runs the timed entry and, in a traced run, installs
the harness's spans and op log on the program's public methods by module
attribute, and removes them again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from ace_tpu_torch.ckks import bootstrap as bootstrap_mod
from ace_tpu_torch.ckks.evaluator import Evaluator
from ace_tpu_torch.compiler import packing
from ace_tpu_torch.compiler.onnx_front import NNGraph, NNOp
from ace_tpu_torch.compiler.relu_ranges import ranges_for
from ace_tpu_torch.compiler.scheme_info import SchemeConfig
from ace_tpu_torch.models import resnet
from ace_tpu_torch import ops as kernel_ops


def graph(net: list, weights: dict) -> NNGraph:
    """The program's graph of the harness's network, as an ONNX export
    of it would load (BN folded, transB Gemm)."""
    ops, w = [], {}
    for ly in net:
        shape_in = (1, ly.cin, ly.hw, ly.hw)
        if ly.op == "conv":
            wt, b = weights[ly.name]
            w[f"{ly.name}.w"] = wt.detach().cpu().numpy().astype(np.float32)
            w[f"{ly.name}.b"] = b.detach().cpu().numpy().astype(np.float32)
            pad = ly.k // 2
            ops.append(NNOp(
                "Conv", ly.name, [ly.inputs[0], f"{ly.name}.w",
                                  f"{ly.name}.b"], [ly.output],
                {"dilations": [1, 1], "group": 1,
                 "kernel_shape": [ly.k, ly.k], "pads": [pad] * 4,
                 "strides": [ly.stride, ly.stride]},
                shape_in, (1, ly.cout, ly.hw // ly.stride,
                           ly.hw // ly.stride)))
        elif ly.op == "relu":
            ops.append(NNOp("Relu", ly.name, ly.inputs, [ly.output], {},
                            shape_in, shape_in))
        elif ly.op == "add":
            ops.append(NNOp("Add", ly.name, ly.inputs, [ly.output], {},
                            shape_in, shape_in))
        elif ly.op == "gap":
            ops.append(NNOp("GlobalAveragePool", ly.name, ly.inputs,
                            [ly.output], {}, shape_in, (1, ly.cin, 1, 1)))
        elif ly.op == "reshape":
            w["/Constant_output_0"] = np.array([1, -1], dtype=np.int64)
            ops.append(NNOp("Reshape", ly.name,
                            [ly.inputs[0], "/Constant_output_0"],
                            [ly.output], {}, (1, ly.cin, 1, 1),
                            (1, ly.cin)))
        elif ly.op == "gemm":
            wt, b = weights[ly.name]
            w["fc.weight"] = wt.detach().cpu().numpy().astype(np.float32)
            w["fc.bias"] = b.detach().cpu().numpy().astype(np.float32)
            ops.append(NNOp("Gemm", ly.name,
                            [ly.inputs[0], "fc.weight", "fc.bias"],
                            [ly.output], {"alpha": 1.0, "beta": 1.0,
                                          "transB": 1},
                            (1, ly.cin), (1, ly.cout)))
    return NNGraph(ops, w, "input", (1, net[0].cin, net[0].hw, net[0].hw),
                   net[-1].output)


# the scheme keys every configuration states; `relu_ranges` names a table
# of compiler/relu_ranges.py, which gives SchemeConfig's relu_value_range
# and relu_ranges
REQUIRED = ("security_level", "hamming_weight", "first_mod_size",
            "scaling_mod_size", "relu_mul_depth", "relu_ranges",
            "use_bootstrap")


def scheme_options(scheme: dict) -> dict:
    """SchemeConfig's keyword arguments that a configuration's `scheme`
    states as they are: every key but `relu_ranges`, each a field of
    SchemeConfig. Raises KeyError for a required key it lacks, and
    ValueError, naming the key, for one that names no field or for
    `relu_value_range`, which the table gives."""
    fields = {f.name for f in dataclasses.fields(SchemeConfig)}
    for key in scheme:
        if key == "relu_value_range":
            raise ValueError("scheme key 'relu_value_range': the table "
                             "that relu_ranges names gives it")
        if key not in fields:
            raise ValueError(f"scheme key {key!r} names no field of "
                             f"SchemeConfig")
    missing = [k for k in REQUIRED if k not in scheme]
    if missing:
        raise KeyError(f"scheme lacks the required keys {missing}")
    return {k: v for k, v in scheme.items() if k != "relu_ranges"}


class Program:
    """One compiled model of the program and its timed entry."""

    def __init__(self, net: list, weights: dict, calibration: np.ndarray,
                 scheme: dict, outputs: int, device):
        options = scheme_options(scheme)
        self.graph = graph(net, weights)
        vr_default, vr = ranges_for(scheme["relu_ranges"])
        vr_default, vr = resnet.calibrate_relu_ranges(
            self.graph, calibration, vr_default, vr)
        cfg = SchemeConfig(**options, relu_value_range=vr_default,
                           relu_ranges=vr)
        self.model = resnet.compile_model(self.graph, cfg,
                                          num_classes=outputs, device=device)
        self.cuda = self.model.ctx.device.type == "cuda"

    def ring(self) -> dict:
        crt = self.model.ctx.params.crt
        si = self.model.scheme
        return {"degree": si.poly_degree, "num_q": crt.num_q,
                "num_p": crt.num_p, "q_parts": si.q_part_num,
                "input_level": si.input_level}

    def infer(self, image: np.ndarray) -> np.ndarray:
        """The timed entry: one encrypted image, the card synchronized."""
        out = resnet.infer_encrypted(self.model, image)
        if self.cuda:
            torch.cuda.synchronize()
        return np.asarray(out, dtype=np.float64)

    def stats(self) -> dict:
        ctx = self.model.ctx
        return {"programs": ctx.evaluator.program_stats(),
                "key_bytes": ctx.key_memory_bytes()}

    def close(self) -> None:
        """Drop the program's state (keys, programs, graph pool)."""
        self.model = None


# -- the traced run's instrumentation ---------------------------------------

# Evaluator methods the op log records: the public operations the graph
# runner, the ReLU and the bootstrap call
LOGGED = ("add", "sub", "negate", "add_plain", "sub_plain", "add_const",
          "mul_plain", "mul_const", "mul_integer", "mul_by_monomial", "mul",
          "rescale", "upscale", "rotate", "conjugate",
          "rotations_hoisted", "rot_sum_jit", "rot_ext_mac_groups_jit",
          "rot_mac_groups_msgs_jit", "bsgs_iter_jit", "encrypt", "decrypt")


def _record(name: str, args: tuple) -> dict | None:
    """The op log's record of Evaluator.<name>(*args), or None for an
    operation without work (a rotation by 0)."""
    a = args[0]
    if name in ("add", "sub"):
        return {"kind": name, "level": min(a.level, args[1].level)}
    if name in ("negate", "add_plain", "sub_plain", "add_const",
                "mul_const", "mul_integer", "mul_by_monomial", "rescale",
                "upscale"):
        return {"kind": name, "level": a.level}
    if name == "mul_plain":
        return {"kind": name, "level": a.level, "num_p": a.c0.num_p}
    if name == "mul":
        return {"kind": "mul", "level": min(a.level, args[1].level)}
    if name == "rotate":
        return None if args[1] == 0 else {"kind": "rotate",
                                          "level": a.level}
    if name == "conjugate":
        return {"kind": "rotate", "level": a.level}
    if name == "rotations_hoisted":
        return {"kind": name, "level": a.level,
                "rotations": sum(r != 0 for r in args[1])}
    if name == "rot_sum_jit":
        return {"kind": "rot_sum", "level": a[0][0].level,
                "inputs": len(a), "rotations": sum(r != 0 for _, r in a)}
    if name == "rot_ext_mac_groups_jit":
        groups = args[2]
        return {"kind": "rot_mac_groups", "level": a.level,
                "rotations": sum(r != 0 for r in args[1]),
                "groups": len(groups),
                "plaintexts": sum(p is not None for g in groups for p in g)}
    if name == "rot_mac_groups_msgs_jit":
        m = args[2]
        return {"kind": "rot_mac_groups_msgs", "level": a.level,
                "rotations": sum(r != 0 for r in args[1]),
                "groups": int(m.shape[0]),
                "messages": int(m.shape[0] * m.shape[1])}
    if name == "bsgs_iter_jit":
        giant = args[2]
        m = args[3]
        return {"kind": "bsgs", "level": a.level,
                "rotations": sum(r != 0 for r in args[1]),
                "giant_switches": sum(r != 0 for r in giant[1:]),
                "messages": int(m.shape[0] * m.shape[1])}
    if name == "encrypt":
        return {"kind": "encrypt", "level": a.poly.num_q}
    if name == "decrypt":
        return {"kind": "decrypt", "level": a.level}
    raise KeyError(name)


class Instruments:
    """Spans and the op log of a traced run.

    - spans: CUDA events recorded before and after each call of
      packing.conv2d and BootstrapContext.bootstrap; `end_image()` sums
      their device time into the current image's totals;
    - op log: one record per outermost call of a LOGGED Evaluator method
      (and the bootstrap's mod-raise), aggregated per image;
    - a profiler hook: `on_relu(n)` is called after the image's n-th
      ReLU;
    - every span and operation also opens a torch.profiler annotation
      named "fhb/<name>", which labels the device's idle gaps.
    """

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events = {"conv": [], "bootstrap": []}
        self.images = []            # per image: {"conv": s, ...}
        self.log = {}               # the current image's ops: key -> count
        self.logs = []              # per image: list of records
        self.depth = 0
        self.relus = 0
        self.on_relu = None

    def _span(self, name: str, fn):
        ins = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(f"fhb/{name}"):
                if not ins.cuda:
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    ins.events[name].append(time.perf_counter() - t0)
                    return out
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                ins.events[name].append((start, end))
                return out

        return wrapped

    def _logged(self, name: str, fn):
        ins = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if ins.depth:
                return fn(*args, **kwargs)
            rec = _record(name, args[1:])
            if rec is not None:
                key = tuple(sorted(rec.items()))
                ins.log[key] = ins.log.get(key, 0) + 1
            ins.depth += 1
            try:
                with torch.profiler.record_function(f"fhb/{name}"):
                    return fn(*args, **kwargs)
            finally:
                ins.depth -= 1

        return wrapped

    def _bootstrap(self, fn):
        ins = self

        @functools.wraps(fn)
        def wrapped(bts, ct, *args, **kwargs):
            key = tuple(sorted({"kind": "mod_raise",
                                "level": bts.ev.params.crt.num_q}.items()))
            ins.log[key] = ins.log.get(key, 0) + 1
            return fn(bts, ct, *args, **kwargs)

        return wrapped

    def _relu(self, fn):
        ins = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function("fhb/relu"):
                out = fn(*args, **kwargs)
            ins.relus += 1
            if ins.on_relu is not None:
                ins.on_relu(ins.relus)
            return out

        return wrapped

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place on the program's modules, removed on
        exit."""
        saved = [(packing, "conv2d", packing.conv2d),
                 (bootstrap_mod.BootstrapContext, "bootstrap",
                  bootstrap_mod.BootstrapContext.bootstrap),
                 (packing.FheBackend, "relu", packing.FheBackend.relu)]
        saved += [(Evaluator, n, getattr(Evaluator, n)) for n in LOGGED]
        try:
            packing.conv2d = self._span("conv", packing.conv2d)
            bootstrap_mod.BootstrapContext.bootstrap = self._span(
                "bootstrap",
                self._bootstrap(bootstrap_mod.BootstrapContext.bootstrap))
            packing.FheBackend.relu = self._relu(packing.FheBackend.relu)
            for n in LOGGED:
                setattr(Evaluator, n, self._logged(n, getattr(Evaluator, n)))
            yield self
        finally:
            for obj, name, fn in saved:
                setattr(obj, name, fn)

    def start_image(self) -> None:
        self.log = {}
        self.relus = 0
        for v in self.events.values():
            v.clear()

    def end_image(self) -> None:
        """Close the current image (after the device synchronized)."""
        totals = {}
        for name, evs in self.events.items():
            totals[name] = sum(e if isinstance(e, float)
                               else e[0].elapsed_time(e[1]) / 1e3
                               for e in evs)
        self.images.append(totals)
        self.logs.append([dict(k, count=c) for k, c in self.log.items()])


def kernel_limbs() -> dict:
    """Limbs the program's NTT kernels (K3, K4) transformed so far."""
    return kernel_ops.read_limbs()


NTT_KERNEL_PREFIX = "ntt_cluster"
