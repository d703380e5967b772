"""LLaMA-style attention-block graph builder (experimental parity).

The reference's nn-addon/llama (llama.cxx:18-54, llama_impl.cxx) builds
an AIR graph for one transformer attention block — RMSNORM, q/k/v
MATMULs, ROPE_ROTARY, RESHAPE_KV/REPEAT_KV (kv cache), TRANSPOSE,
scores = q k^T / sqrt(d), SOFTMAX, value matmul — without lowering it
to FHE (the VECTOR pass does not cover these ops there either). This
module provides the graph as an NNGraph, plus a plain executor for the
extended op set so the block runs end-to-end in the clear (the oracle
an encrypted transformer lowering validates against).

A copy of `ace_tpu.models.llama` on the port's own NNOp and NNGraph:
numpy only, so the same weights feed both packages.
"""

from __future__ import annotations

import numpy as np

from ace_tpu_torch.compiler.onnx_front import NNOp, NNGraph

EMBED = 4096        # ARRAY_SIZE, llama_impl.cxx:27
N_HEADS = 32
HEAD_DIM = EMBED // N_HEADS


def build_attention_block(seq: int = 1, embed: int = EMBED,
                          n_heads: int = N_HEADS,
                          n_rep: int = 6) -> NNGraph:
    """One attention block following llama.cxx:20-54's op sequence."""
    rng = np.random.default_rng(0)
    head_dim = embed // n_heads

    def w(name, *shape):
        return name, rng.standard_normal(shape).astype(np.float32) * 0.02

    weights = dict([
        w("rms_weight", embed),
        w("wq", embed, embed),
        w("wk", embed, embed),
        w("wv", embed, embed),
        ("rope_freqs", np.arange(head_dim // 2, dtype=np.float32)),
        ("head_dim_weight", np.asarray([float(head_dim)], np.float32)),
    ])

    ops = [
        NNOp("Rmsnorm", "rmsnorm0", ["input", "rms_weight"],
             ["rms_out"], {}, (1, seq, embed), (1, seq, embed)),
        NNOp("Matmul", "mm_q", ["rms_out", "wq"], ["xq"], {},
             (1, seq, embed), (1, seq, embed)),
        NNOp("Matmul", "mm_k", ["rms_out", "wk"], ["xk"], {},
             (1, seq, embed), (1, seq, embed)),
        NNOp("Matmul", "mm_v", ["rms_out", "wv"], ["xv"], {},
             (1, seq, embed), (1, seq, embed)),
        NNOp("RopeRotary", "rope0", ["xq", "xk", "rope_freqs"],
             ["rq", "rk"], {"n_heads": n_heads},
             (1, seq, embed), (1, seq, embed)),
        NNOp("ReshapeKv", "kv0", ["rq", "rk", "xv"],
             ["cached_k", "cached_v"], {"start_pos": 0},
             (1, seq, embed), (1, seq, embed)),
        NNOp("RepeatKv", "rep_k", ["cached_k"], ["keys"],
             {"n_rep": n_rep}, (1, seq, embed), (1, seq, embed)),
        NNOp("RepeatKv", "rep_v", ["cached_v"], ["values"],
             {"n_rep": n_rep}, (1, seq, embed), (1, seq, embed)),
        NNOp("Transpose", "tr_k", ["keys"], ["keys_t"],
             {"axes": (2, 3)}, None, None),
        NNOp("Matmul", "mm_scores", ["rq", "keys_t"], ["attn_w"], {},
             None, None),
        NNOp("Sqrt", "sqrt0", ["head_dim_weight"], ["sqrt_d"], {},
             None, None),
        NNOp("Divide", "div0", ["attn_w", "sqrt_d"], ["scores"], {},
             None, None),
        NNOp("Softmax", "sm0", ["scores"], ["probs"], {}, None, None),
        NNOp("Matmul", "mm_out", ["probs", "values"], ["attn"], {},
             None, None),
        NNOp("Transpose", "tr_out", ["attn"], ["out"],
             {"axes": (1, 2)}, None, None),
    ]
    return NNGraph(ops, weights, "input", (1, seq, embed), "out")


def run_plain(graph: NNGraph, x: np.ndarray) -> np.ndarray:
    """Plain numpy executor for the llama op set (the *_REF analog)."""
    env = {graph.input_name: np.asarray(x, np.float64)}
    w = {k: np.asarray(v, np.float64) for k, v in graph.weights.items()}
    seq = x.shape[1]
    n_heads = next(op.attrs["n_heads"] for op in graph.ops
                   if op.op_type == "RopeRotary")

    def heads(t):  # [1, seq, embed] -> [1, n_heads, seq, head_dim]
        e = t.shape[-1]
        hd = e // n_heads
        return t.reshape(1, seq, n_heads, hd).transpose(0, 2, 1, 3)

    for op in graph.ops:
        a = env.get(op.inputs[0], w.get(op.inputs[0]))
        if op.op_type == "Rmsnorm":
            g = w[op.inputs[1]]
            v = a / np.sqrt(np.mean(a * a, axis=-1, keepdims=True) + 1e-5)
            env[op.outputs[0]] = v * g
        elif op.op_type == "Matmul":
            b = env.get(op.inputs[1], w.get(op.inputs[1]))
            if b.ndim == 2:
                env[op.outputs[0]] = a @ b.T
            else:
                if a.ndim != b.ndim:  # q enters head-shaped attention
                    a = env.get("_rq_heads")
                env[op.outputs[0]] = a @ b
        elif op.op_type == "RopeRotary":
            xq, xk = a, env[op.inputs[1]]
            freqs = w[op.inputs[2]]
            hd = xq.shape[-1] // n_heads
            ang = np.outer(np.arange(seq),
                           1.0 / (10000.0 ** (2 * freqs / hd)))
            cos, sin = np.cos(ang), np.sin(ang)

            def rope(t):
                th = t.reshape(1, seq, n_heads, hd)
                tr = th[..., 0::2]
                ti = th[..., 1::2]
                rr = tr * cos[None, :, None, :] - ti * sin[None, :, None, :]
                ri = tr * sin[None, :, None, :] + ti * cos[None, :, None, :]
                out = np.empty_like(th)
                out[..., 0::2] = rr
                out[..., 1::2] = ri
                return out.reshape(t.shape)
            env[op.outputs[0]] = rope(xq)
            env[op.outputs[1]] = rope(xk)
        elif op.op_type == "ReshapeKv":
            env[op.outputs[0]] = heads(env[op.inputs[1]])
            env[op.outputs[1]] = heads(env[op.inputs[2]])
            env["_rq_heads"] = heads(env[op.inputs[0]])
        elif op.op_type == "RepeatKv":
            env[op.outputs[0]] = np.repeat(a, op.attrs["n_rep"], axis=1) \
                if a.shape[1] * op.attrs["n_rep"] == n_heads else a
        elif op.op_type == "Transpose":
            ax = op.attrs["axes"]
            perm = list(range(a.ndim))
            perm[ax[0]], perm[ax[1]] = perm[ax[1]], perm[ax[0]]
            env[op.outputs[0]] = a.transpose(perm)
        elif op.op_type == "Sqrt":
            env[op.outputs[0]] = np.sqrt(w[op.inputs[0]])
        elif op.op_type == "Divide":
            env[op.outputs[0]] = a / env.get(op.inputs[1],
                                             w.get(op.inputs[1]))
        elif op.op_type == "Softmax":
            if op.inputs[0] == "scores" and "_rq_heads" in env:
                pass
            e = np.exp(a - a.max(axis=-1, keepdims=True))
            env[op.outputs[0]] = e / e.sum(axis=-1, keepdims=True)
        else:
            raise NotImplementedError(op.op_type)
    return env[graph.output_name]
