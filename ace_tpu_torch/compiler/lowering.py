"""Graph executor: run an NNGraph on a slot backend.

The capability analog of the reference's whole lowering pipeline
(VECTOR -> SIHE -> CKKS passes): each NN op dispatches to the packing
metakernels; ReLU goes through the composite-sign approximation (with
optional bootstrap to refresh levels first); scale management is inline
in the FheBackend. The same executor runs the plain numpy backend for
validation (the analog of -VEC:rtt runtime validation).
"""

from __future__ import annotations

import numpy as np

from ace_tpu_torch.compiler import packing as pk
from ace_tpu_torch.compiler.onnx_front import NNGraph


class GraphRunner:
    def __init__(self, graph: NNGraph, backend,
                 relu_ranges: dict | None = None,
                 relu_range_default: float = 3.0,
                 relu_mul_depth: int = 13,
                 bootstrap_before_relu: bool = False,
                 trace=None):
        self.g = graph
        self.be = backend
        self.relu_ranges = relu_ranges or {}
        self.relu_range_default = relu_range_default
        self.relu_mul_depth = relu_mul_depth
        self.bootstrap_before_relu = bootstrap_before_relu
        self.trace = trace  # callable(msg) — the -trace per-op log

    def run(self, x, checkpoint: str = ""):
        """x: packed input handle (plain vector or ciphertext) holding
        the NCHW-flattened image.

        checkpoint: optional .npz path; when set, the live environment
        is persisted after every op and an existing file resumes the
        run at its recorded op index (exact: the level trajectory is
        static), its ciphertexts placed on x's device. Plain-ciphertext
        backends only."""
        import os as _os
        import time as _time
        from ace_tpu_torch.runtime.timing import TIMING
        be = self.be
        crt = getattr(getattr(be, "ev", None), "crt", None)
        if checkpoint and crt is not None and crt.sharded:
            raise NotImplementedError(
                "checkpoints hold whole ciphertexts; a limb-sharded run "
                "(FheContext(mesh=...)) has no checkpoint path")
        env = {self.g.input_name: x}
        start_idx = 0
        if checkpoint and _os.path.exists(checkpoint):
            from ace_tpu_torch.runtime import ckpt as _ckpt
            env, start_idx = _ckpt.load(checkpoint, x.c0.data.device)
            if self.trace is not None:
                self.trace(f"resumed checkpoint at op {start_idx + 1}/"
                           f"{len(self.g.ops)}")
        # names still needed strictly after op i (for dead-value drop)
        needed_after = [set() for _ in self.g.ops]
        live = {self.g.output_name}
        for i in range(len(self.g.ops) - 1, -1, -1):
            needed_after[i] = set(live)
            live.update(n for n in self.g.ops[i].inputs
                        if n not in self.g.weights)
        for op_idx, op in enumerate(self.g.ops):
            if op_idx < start_idx:
                continue
            t_op = _time.perf_counter()
            xin = env[op.inputs[0]]
            if op.op_type == "Conv":
                w = np.asarray(self.g.weights[op.inputs[1]], np.float64)
                b = (np.asarray(self.g.weights[op.inputs[2]], np.float64)
                     if len(op.inputs) > 2 else np.zeros(w.shape[0]))
                stride = op.attrs.get("strides", [1, 1])[0]
                _, _, h, wd = op.in_shape
                out = pk.conv2d(be, xin, w, b, h, wd, stride)
            elif op.op_type == "Relu":
                out = self._relu(xin, op)
            elif op.op_type in ("Add", "Sub", "Mul"):
                rhs = op.inputs[1]
                if rhs in env:
                    fn = {"Add": be.add, "Sub": be.sub,
                          "Mul": be.mul}[op.op_type]
                    out = fn(xin, env[rhs])
                else:
                    # constant operand (broadcast to the op's shape)
                    w = np.broadcast_to(
                        np.asarray(self.g.weights[rhs], np.float64),
                        op.in_shape).reshape(-1)
                    if op.op_type == "Add":
                        out = be.add_plain(xin, w)
                    elif op.op_type == "Sub":
                        out = be.add_plain(xin, -w)
                    else:
                        out = be.mul_plain(xin, w)
            elif op.op_type == "Slice":
                # contiguous flat slice (StridedSlice analog): rotate
                # the region to slot 0, mask the tail junk
                start = op.attrs["_flat_start"]
                ln = op.attrs["_flat_len"]
                out = xin if start == 0 else be.rotate(xin, start)
                mask = np.zeros(be.n_slots)
                mask[:ln] = 1.0
                out = be.mul_plain(out, mask)
            elif op.op_type == "GlobalAveragePool":
                _, c, h, wd = op.in_shape
                out = pk.global_average_pool(be, xin, c, h, wd)
            elif op.op_type in ("AveragePool", "MaxPool"):
                # reference maps MaxPool to AveragePool under FHE
                # (t2vslice_handler.h:92-95)
                _, c, h, wd = op.in_shape
                k = op.attrs["kernel_shape"][0]
                out = pk.average_pool(be, xin, c, h, wd, k)
            elif op.op_type in ("Reshape", "Flatten"):
                out = xin
            elif op.op_type == "Gemm":
                w = np.asarray(self.g.weights[op.inputs[1]], np.float64)
                if op.attrs.get("transB", 0) == 0:
                    w = w.T
                b = (np.asarray(self.g.weights[op.inputs[2]], np.float64)
                     if len(op.inputs) > 2 else np.zeros(w.shape[0]))
                # fold alpha/beta (Gemm: Y = alpha*A@B + beta*C)
                w = w * float(op.attrs.get("alpha", 1.0))
                b = b * float(op.attrs.get("beta", 1.0))
                out_dim, in_dim = w.shape
                rows = 1
                while rows < out_dim:
                    rows *= 2
                # gemm needs rows | in_dim; zero-pad input columns up
                # (zero weights null out whatever sits in the padded
                # slots, e.g. cifar100's 100 classes over 64 features)
                in_pad = max(in_dim, rows * ((in_dim + rows - 1) // rows))
                w_pad = np.zeros((rows, in_pad))
                w_pad[:out_dim, :in_dim] = w
                b_pad = np.zeros(rows)
                b_pad[:out_dim] = b
                out = pk.gemm(be, xin, w_pad, b_pad)
            else:
                raise NotImplementedError(op.op_type)
            env[op.outputs[0]] = out
            # drop values no op after this one reads (bounds HBM)
            for dead in [n for n in env if n not in needed_after[op_idx]]:
                del env[dead]
            # per-op timing buckets in the reference's perf.py naming
            # (Tensor::conv / FHE::relu lines, rtlib_timing.h)
            bucket = ("FHE::relu" if op.op_type == "Relu"
                      else f"Tensor::{op.op_type.lower()}")
            dt = _time.perf_counter() - t_op
            TIMING.add(bucket, dt)
            if self.trace is not None:
                self.trace(f"[{op_idx + 1}/{len(self.g.ops)}] "
                           f"{op.op_type} {op.name}: {dt:.2f}s")
            if checkpoint:
                from ace_tpu_torch.runtime import ckpt as _ckpt
                _ckpt.save(checkpoint, env, op_idx + 1)
        return env[self.g.output_name]

    def _relu(self, xin, op):
        vr = self.relu_ranges.get(op.name, self.relu_range_default)
        if getattr(self, "relu_observe", None) is not None:
            # range-calibration probe (plain backend only): record the
            # per-ReLU peak |input| — the on-the-fly analog of the
            # reference's dataset calibration that produced the
            # build_resnet*.sh per-ReLU ranges
            v = np.asarray(xin.vec if hasattr(xin, "vec") else xin)
            self.relu_observe[op.name] = max(
                self.relu_observe.get(op.name, 0.0),
                float(np.max(np.abs(v))))
        return self.be.relu(xin, vr, self.relu_mul_depth,
                            self.bootstrap_before_relu)
