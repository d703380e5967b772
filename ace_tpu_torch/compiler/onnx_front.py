"""ONNX front-end: ModelProto -> NN op graph.

Replaces the reference's onnx2air (nn-addon/onnx2air/src/air_gen.cxx)
with a thin Python importer: parses the protobuf (bindings generated
from the standard onnx.proto schema), resolves initializers/constants,
infers NCHW shapes, and yields a topologically-ordered op list ready
for slot-packing lowering. Supported ops match the reference's dispatch
table (nn-addon/include/nn/onnx2air/air_stmt.h:25-36): Add, AveragePool,
Constant, Conv, Flatten, Gemm, GlobalAveragePool, MaxPool, Mul, Relu,
Reshape.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

_PB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_onnx")


def _onnx_pb2():
    """The generated ONNX bindings, imported on first use: they need
    protobuf, which the graph types and the native model builders do
    not."""
    if _PB_DIR not in sys.path:
        sys.path.insert(0, _PB_DIR)
    import onnx_pb2  # generated from the standard ONNX schema
    return onnx_pb2

_DTYPE = {1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64}


@dataclasses.dataclass
class NNOp:
    op_type: str
    name: str
    inputs: list
    outputs: list
    attrs: dict
    in_shape: tuple | None = None   # NCHW shape of the data input
    out_shape: tuple | None = None


@dataclasses.dataclass
class NNGraph:
    ops: list
    weights: dict            # name -> np.ndarray
    input_name: str
    input_shape: tuple
    output_name: str


def _tensor_to_np(t) -> np.ndarray:
    dtype = _DTYPE[t.data_type]
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dtype)
    elif t.float_data:
        arr = np.asarray(t.float_data, dtype=dtype)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, dtype=dtype)
    elif t.int32_data:
        arr = np.asarray(t.int32_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    return arr.reshape([d for d in t.dims]) if t.dims else arr


def _attr_value(a):
    onnx_pb2 = _onnx_pb2()
    if a.type == onnx_pb2.AttributeProto.INT:
        return int(a.i)
    if a.type == onnx_pb2.AttributeProto.INTS:
        return [int(v) for v in a.ints]
    if a.type == onnx_pb2.AttributeProto.FLOAT:
        return float(a.f)
    if a.type == onnx_pb2.AttributeProto.FLOATS:
        return [float(v) for v in a.floats]
    if a.type == onnx_pb2.AttributeProto.TENSOR:
        return _tensor_to_np(a.t)
    if a.type == onnx_pb2.AttributeProto.STRING:
        return a.s.decode()
    return None


def _slice_params(op, in_shape, weights):
    """Static Slice (the StridedSlice analog, nn-addon opcode_def.inc):
    starts/ends/axes come from attributes (opset<10) or initializer
    inputs (opset>=10). Only step 1 and a flat-contiguous result are
    supported: the sliced axis must have all earlier axes of size 1 so
    the region is one contiguous run of slots."""
    if "starts" in op.attrs:
        starts = list(op.attrs["starts"])
        ends = list(op.attrs["ends"])
        axes = list(op.attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    else:
        def const(i, default=None):
            if i < len(op.inputs) and op.inputs[i] in weights:
                return [int(v) for v in np.atleast_1d(weights[op.inputs[i]])]
            return default
        starts = const(1)
        ends = const(2)
        axes = const(3, list(range(len(starts or []))))
        steps = const(4, [1] * len(starts or []))
        if starts is None or ends is None:
            raise NotImplementedError(
                f"Slice {op.name}: dynamic starts/ends unsupported")
    if any(st != 1 for st in steps):
        raise NotImplementedError(f"Slice {op.name}: steps != 1")
    out = list(in_shape)
    flat_start, flat_len = 0, None
    for ax, st, en in zip(axes, starts, ends):
        ax = ax % len(in_shape)
        dim = in_shape[ax]
        st = max(0, st + dim if st < 0 else min(st, dim))
        en = max(0, en + dim if en < 0 else min(en, dim))
        if en <= st:
            raise NotImplementedError(f"Slice {op.name}: empty slice")
        if st != 0 or en != dim:
            if any(d != 1 for d in in_shape[:ax]):
                raise NotImplementedError(
                    f"Slice {op.name}: non-contiguous slice on axis "
                    f"{ax} of {in_shape}")
            inner = int(np.prod(in_shape[ax + 1:])) if ax + 1 < len(
                in_shape) else 1
            flat_start += st * inner
            flat_len = (en - st) * inner
        out[ax] = en - st
    if flat_len is None:
        flat_len = int(np.prod(out))
    return tuple(out), flat_start, flat_len


def _slice_out_shape(op, in_shape, weights):
    out, start, length = _slice_params(op, in_shape, weights)
    op.attrs["_flat_start"] = start
    op.attrs["_flat_len"] = length
    return out


def load_onnx(path: str) -> NNGraph:
    model = _onnx_pb2().ModelProto()
    with open(path, "rb") as f:
        model.ParseFromString(f.read())
    g = model.graph

    weights = {init.name: _tensor_to_np(init) for init in g.initializer}

    # fold Constant nodes into weights
    ops = []
    for node in g.node:
        attrs = {a.name: _attr_value(a) for a in node.attribute}
        if node.op_type == "Constant":
            weights[node.output[0]] = attrs["value"]
            continue
        ops.append(NNOp(node.op_type, node.name or node.output[0],
                        list(node.input), list(node.output), attrs))

    graph_input = None
    for vi in g.input:
        if vi.name not in weights:
            graph_input = vi
    assert graph_input is not None
    in_shape = tuple(d.dim_value
                     for d in graph_input.type.tensor_type.shape.dim)

    # shape inference (NCHW only, batch must be 1)
    shapes = {graph_input.name: in_shape}
    for op in ops:
        data_in = op.inputs[0]
        s = shapes.get(data_in)
        op.in_shape = s
        if op.op_type == "Conv":
            w = weights[op.inputs[1]]
            strides = op.attrs.get("strides", [1, 1])
            kh, kw = int(w.shape[2]), int(w.shape[3])
            pads = [int(v) for v in op.attrs.get("pads",
                                                 [0, 0, 0, 0])]
            dil = op.attrs.get("dilations", [1, 1])
            grp = int(op.attrs.get("group", 1))
            # the packing metakernels compute SAME-padded convs
            # (rotation taps wrap within the channel block); reject
            # anything else loudly instead of producing wrong numbers
            if list(dil) != [1, 1]:
                raise NotImplementedError(
                    f"Conv {op.name}: dilations {dil} unsupported")
            if grp != 1:
                raise NotImplementedError(
                    f"Conv {op.name}: group={grp} unsupported")
            if (pads[0] + pads[2] != kh - 1
                    or pads[1] + pads[3] != kw - 1):
                raise NotImplementedError(
                    f"Conv {op.name}: pads {pads} are not SAME padding "
                    f"for kernel {kh}x{kw}; only SAME convs lower to "
                    f"the rotation-tap metakernel")
            if s[2] % strides[0] or s[3] % strides[1]:
                raise NotImplementedError(
                    f"Conv {op.name}: input {s[2]}x{s[3]} not divisible "
                    f"by stride {strides}")
            oh = s[2] // strides[0]
            ow = s[3] // strides[1]
            op.out_shape = (s[0], w.shape[0], oh, ow)
        elif op.op_type in ("Relu", "Add", "Mul", "Sub"):
            op.out_shape = s
        elif op.op_type == "GlobalAveragePool":
            op.out_shape = (s[0], s[1], 1, 1)
        elif op.op_type in ("AveragePool", "MaxPool"):
            k = [int(v) for v in op.attrs["kernel_shape"]]
            strides = [int(v)
                       for v in op.attrs.get("strides", k)]
            pads = [int(v) for v in op.attrs.get("pads",
                                                 [0, 0, 0, 0])]
            if strides != k:
                raise NotImplementedError(
                    f"{op.op_type} {op.name}: strides {strides} != "
                    f"kernel {k}; only non-overlapping pooling lowers")
            if any(pads) or op.attrs.get("ceil_mode", 0):
                raise NotImplementedError(
                    f"{op.op_type} {op.name}: pads/ceil_mode "
                    f"unsupported")
            if s[2] % k[0] or s[3] % k[1]:
                raise NotImplementedError(
                    f"{op.op_type} {op.name}: input {s[2]}x{s[3]} not "
                    f"divisible by kernel {k}")
            op.out_shape = (s[0], s[1], s[2] // k[0], s[3] // k[1])
        elif op.op_type in ("Reshape", "Flatten"):
            op.out_shape = (1, int(np.prod([d for d in s if d])),)
        elif op.op_type == "Gemm":
            w = weights[op.inputs[1]]
            out_dim = w.shape[1] if op.attrs.get("transB", 0) == 0 \
                else w.shape[0]
            op.out_shape = (1, out_dim)
        elif op.op_type == "Slice":
            op.out_shape = _slice_out_shape(op, s, weights)
        else:
            raise NotImplementedError(f"op {op.op_type}")
        shapes[op.outputs[0]] = op.out_shape

    return NNGraph(ops, weights, graph_input.name, in_shape,
                   g.output[0].name)
