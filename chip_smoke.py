#!/usr/bin/env python3
"""Drive the PyTorch port (ace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Twelve phases (11 after 5; 9d after 9, then 10); any failure exits
non-zero and prints no result line. The evaluator runs its ops as op
programs (CUDA graphs captured at an op's second call and replayed
after, ckks/evaluator.py and utils/liftgraph.py), as the main path
does: phases 3-10 run through them, those of phases 9 and 9d split at
the meshes' collectives; phases 9, 9d and 11 hold them against the
eager path.
  1. device and build: the card's name and power limit; the CUDA kernels
     compiled from ace_tpu_torch/csrc (one nvcc per source, in parallel).
  2. kernels, each through kernel_row (see there), its one helper: the
     kernel's wrapper equal, word for word, to its plain PyTorch version
     on the same inputs, then the kernel timed alone (a CUDA graph of
     back-to-back wrapper calls), its plain version's time and launches,
     launch shape and bound. At ResNet-20's shapes: K1 (Barrett
     product), K2 (Shoup product), K3 (forward NTT) and K4 (inverse NTT)
     at N = 2^15 over its whole prime chain (34 q primes and the P
     primes), plus the K3-K4 round trip; K3 and K4 at the slice's own
     limb counts 1, 12, 34; K5 (fast base conversion) at the key
     switch's two shapes, 12 -> 34 (digit 0's mod-up) and 12 P -> 34 q
     (mod-down); K6 (the plaintext-message lift) at [12, 22, N] and
     [8, 46, N].
  3. exactness of whole ops: one rotate and one mul+rescale of a level-34
     ciphertext under the port's own keys, on the card and on the CPU
     (plain versions); the residues must be identical.
  4. the slice: ResNet-20's first residual block (ops[:6] of
     build_resnet_cifar(3), output /layer1/layer1.0/Add_output_0)
     encrypted at N = 2^15 with a 34-prime chain, through compile_model
     and infer_encrypted, cold then warm, against infer_plain; every
     kernel's launch counter must grow during the inference. Its output
     residues are phase 9b's reference.
  5. one bootstrap at the same ring and chain: uniform(-0.7, 0.7) in N/2
     slots at level 2, through FheContext.bootstrap cold and warm;
     levels regained, decoded within 2e-2.
  6. all of ResNet-20 (build_resnet_cifar(3), a bootstrap before each of
     its 19 ReLUs) at the parameters select_params picks, through the
     model zoo's path (scripts/torch_zoo.py: cfg_for, shared_context and
     run_model, i.e. compile_model and infer_encrypted), cold (keys made
     on demand):
     finite logits, argmax equal to infer_plain's, max_err <= 0.1 *
     max|plain|. The kernel rows' `launches` count this inference.
  7. the compile driver and runtime services at ResNet-20's parameters
     (see phase_runtime_services): the driver's manifest and weight file
     from build_resnet_cifar(3) written as ONNX, a context rebuilt from
     them (keys pre-warmed, the weight file through the native loader),
     a validated run (--rtt) that must pass and a perturbed one that
     must raise, and a checkpointed ops[:6] resumed bit-exact.
  8. one encrypted LLaMA attention block at full head width (see
     phase_attention): d = 128 (models/llama.py's 4096 over 32 heads),
     seq = 128, N = 2^15 with 50 q primes; K1-K4 first checked and
     timed (kernel_row) and one rotate and one mul+rescale checked at
     this chain's limb counts; then
     encrypted_attention cold (keys made on demand) against
     attention_plain within 2e-2, stage by stage, and one projection
     under the profiler. The kernel rows' `launches_llama` count the
     block.
  9. the digit x slot SPMD key switch (ace_tpu_torch/parallel, see
     phase_spmd) on worlds of spawned ranks that share the card through
     gloo, with op programs split at the collectives: rotate, mul and
     the conv slice at level 34 on a 3 x 2 world, three calls (eager,
     captured, replayed) each bit-identical to the single-device
     Evaluator, the third timed against the eager path; phase 4's model
     through FheContext(digit_mesh=...) on a 3 x 1 world, three runs
     equal to phase 4's output residues; three rotates through their
     program on a one-rank NCCL world. The kernel rows' `launches_spmd`
     count 9a-9b over all ranks.
 9d. the limb-sharded evaluator (FheContext(mesh=...), see phase_limb)
     on a 2 x 2 (dp x limb) world sharing the card through gloo, with op
     programs split at the collectives: each dp row's rotate, mul,
     rescale and hoisted MAC bundle on its own messages at level 34,
     three calls each bit-identical to the single-device Evaluator, the
     third timed against the eager path, and phase 4's model, three runs
     equal to phase 4's output residues; every rank launches K1-K4. The
     kernel rows' `launches_limb` count 9d over all ranks, and
     `launches_mesh_programs` 9a-9d's calls through programs.
 10. the benchmark entry points at N = 2^16 (bench_torch.py,
     bench_micro_torch.py and the native C library of ops/native.py, see
     phase_bench): the C library's build and the one-thread CPU NTT
     baseline; through kernel_row, K3 and K4 at bench_torch's
     [8, 65536] and K1-K4 over bench_micro_torch's whole chain
     [32, 65536] (24 q + 8 P primes) and its q primes [24, 65536] (the
     rows' `by_shape`); bench_torch's chained NTT passes (NTT/s,
     vs_baseline); bench_micro_torch's context and ops, one rotate and
     one mul+relin+rescale decoded within 1e-4; the full bootstrap
     (2^15 slots) cold and warm and a 2^12-slot sparse one, decoded
     within 2e-2. The kernel rows' `launches_2e16` count
     its bench pass, ops and bootstraps.
 11. (run after 5) the op programs (see phase_programs) on phase 5's
     context: each program kind (rot with a conjugate, mulrl, rs, mp,
     addc, rsum, rmg, rmgm, bsgs) called three times on fresh inputs,
     equal word for word to Evaluator(programs=False) on the same keys,
     with equal kernel-counter growth; each kind's eager call and replay
     timed; phase 5's bootstrap replayed against the eager one (equal
     residues, decoded within 2e-2, timed and profiled for the idle
     share); phase 4's ops[:6] replayed on its input, equal to phase 4's
     output residues. The kernel rows' `launches_programs` count the
     launches through programs there.

The last lines are the card's `name, power.limit`, one JSON object with a
row per kernel (kernel_table: each kernel_row of phases 2, 8 and 10 under
`by_shape`), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the CUDA-core
# float32 rate of 67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz. The
# kernels' arithmetic is 32-bit integer multiply-adds (IMAD), which issue
# on half as many lanes: 132 x 64 x 1.98 GHz = 16.7e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# 32-bit IMADs per 64-bit product: low word 3, high word 4
MUL_LO, MUL_HI = 3, 4
SHOUP_IMAD = MUL_HI + 2 * MUL_LO                    # one Shoup product
BARRETT_IMAD = (MUL_HI + MUL_LO) + MUL_HI + 2 * (MUL_HI + MUL_LO) \
    + 2 * MUL_LO                                    # product + Barrett-128

# ResNet-20 at run_resnet.py's settings (tests/test_torch_slice.py holds
# ace_tpu's select_params to these numbers)
DEGREE, NUM_Q, Q_PARTS = 32768, 34, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, imads: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 10, batch: int = 1) -> float:
    """Median over `reps` samples of the mean time per call of `batch`
    back-to-back calls of fn(i) (i cycles over the input sets), each
    sample between two CUDA events."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(batch):
            fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device_and_build() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.utils.card import card
    name_power = card()
    log(f"[phase 1] card: {name_power}")
    log(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    times = kernels.build_all(verbose=True)
    log(f"[phase 1] built {sorted(times)} in "
        f"{time.perf_counter() - t0:.1f} s into {kernels.build_dir()}")
    return {"card": name_power}


# ---------------------------------------------------------------------------
# Phase 2: the kernels at ResNet-20's shapes
# ---------------------------------------------------------------------------

def phase_kernels(crt) -> list:
    """Every kernel at ResNet-20's shapes through kernel_row: K1-K4 over
    the whole chain [46, N] (4 input sets of 24-36 MB, beyond the 50 MB
    L2, so each launch reads cold data) with the K3-K4 round trip; K3
    and K4 at the slice's own limb counts (rescale's last q limb, the P
    limbs of mod-down, the q chain); K5 at the key switch's two
    conversions (4 sets of 12 MB stay in L2, as K4's fresh output does
    for the K5 launch after it); K6 at the bundles' [R, LK, N]."""
    rng = np.random.default_rng(SEED)
    rows = chain_rows(crt, range(len(crt.all_primes)), "the whole chain",
                      "[phase 2]", rng)
    for what, limbs in (("rescale's last q limb", [NUM_Q - 1]),
                        ("the P limbs", list(range(NUM_Q, crt.num_q
                                                   + crt.num_p))),
                        ("the q chain", list(range(NUM_Q)))):
        rows += ntt_rows(crt.tables_for(limbs), residue_sets(
            [crt.all_primes[r] for r in limbs], crt.degree, crt.device, rng),
            what, "[phase 2]")
    return rows + k5_rows(crt) + k6_rows(crt)


def residue_sets(primes, n: int, device, rng, k: int = 4) -> list:
    """k tensors [len(primes), n] of uniform residues mod primes."""
    from ace_tpu_torch.ops import modops
    return [modops.to_torch(np.stack([rng.integers(0, q, n, dtype=np.uint64)
                                      for q in primes]), device)
            for _ in range(k)]


# What each kernel is, for the JSON rows, and the least work of one call
# of it at its shape, for bound(): bytes of each input and output once
# (K3/K4 also read a twiddle and its Shoup word a coefficient) and 32-bit
# IMADs. K1-K4 take dims (L, n), K5 (O, J, n), K6 (R, LK, n).
KERNELS = {
    "K1": ("barrett_mul", "ace_tpu_torch/csrc/modmul.cu",
           "ace_tpu/ops/pallas_modops.py:246",
           lambda L, n: (3 * L * n * 8, BARRETT_IMAD * L * n)),
    "K2": ("shoup_mul", "ace_tpu_torch/csrc/modmul.cu",
           "ace_tpu/ops/pallas_modops.py:229",
           lambda L, n: (2 * L * n * 8, SHOUP_IMAD * L * n)),
    "K3": ("ntt4_fwd", "ace_tpu_torch/csrc/ntt.cu", "ace_tpu/ops/ntt4.py:510",
           lambda L, n: (4 * L * n * 8, SHOUP_IMAD * L * (n // 2)
                         * (n.bit_length() - 1))),
    "K4": ("ntt4_inv", "ace_tpu_torch/csrc/ntt.cu", "ace_tpu/ops/ntt4.py:515",
           lambda L, n: (4 * L * n * 8, SHOUP_IMAD * L * (n // 2)
                         * (n.bit_length() + 1))),
    "K5": ("base_conv", "ace_tpu_torch/csrc/baseconv.cu",
           "none (ace_tpu's base conversion is jnp code, poly/poly.py "
           "_base_conv_data)",
           lambda O, J, n: ((O + J) * n * 8, n * (
               O * J * (MUL_HI + MUL_LO) + O * SHOUP_IMAD
               + J * (BARRETT_IMAD - MUL_HI - MUL_LO)))),
    "K6": ("lift_msgs", "ace_tpu_torch/csrc/lift.cu",
           "none (ace_tpu's lift is jnp code inside its bundles, "
           "ckks/evaluator.py _mac_msgs)",
           lambda R, LK, n: ((R + R * LK) * n * 8,
                             R * LK * n * 2 * (MUL_HI + MUL_LO))),
}
GRAPH_CALLS = 20  # wrapper calls captured into one graph by kernel_row


def launch_text(key: str, dims: tuple) -> str:
    """The launch shape of one call of kernel `key` at `dims`."""
    from ace_tpu_torch.ops import baseconv, lift
    if key in ("K1", "K2"):
        L, n = dims
        return (f"grid {min((L * n + 255) // 256, 132 * 64)} x 256 "
                f"threads, grid-stride")
    if key in ("K3", "K4"):
        return ntt_shape(*dims)
    if key == "K5":
        J, n = dims[1:]
        r = baseconv.slice_rows(J)
        return (f"grid {-(-n // 128)} x {-(-J // r)} blocks of 128 "
                f"threads, {r} target rows a block")
    return (f"grid {' x '.join(map(str, lift.launch_shape(*dims)))} blocks "
            f"of {lift.THREADS} threads")


def kernel_row(key: str, wrapper, plain, arg_sets: list, dims: tuple,
               what: str, tag: str) -> dict:
    """Kernel `key` through its wrapper against its plain version.
    Everywhere: wrapper(*arg_sets[0]) must equal plain(*arg_sets[0]) word
    for word. On the card also: `ms`, the kernel alone, from GRAPH_CALLS
    back-to-back wrapper calls cycling over the argument sets captured
    into one CUDA graph (the check's call before it loaded the library
    and set the kernel's attributes; the counters are set back after the
    capture), replayed between CUDA events, median of 10; `plain_ms`, one
    plain call, median of 10; `plain_launches`, the CUDA kernels one
    plain call launches; the bound from KERNELS' work at `dims`. Hand
    it contiguous, 16-byte-aligned inputs, so that the wrappers copy
    nothing into the graph."""
    import torch
    from ace_tpu_torch import ops
    got, want = wrapper(*arg_sets[0]), plain(*arg_sets[0])
    shape = f"[{', '.join(map(str, dims))}]"
    if not torch.equal(got, want):
        raise AssertionError(f"{tag} {key} at {shape} ({what}) differs from "
                             f"the plain version")
    row = {"kernel": key, "phase": tag, "shape": shape, "what": what}
    if not got.is_cuda:
        log(f"{tag} {key} at {shape} ({what}): equal to its plain version")
        return row
    counters = ops.counter_state()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(GRAPH_CALLS):
            wrapper(*arg_sets[i % len(arg_sets)])
    ops.restore_counters(counters)
    ms = time_ms(lambda i: graph.replay()) / GRAPH_CALLS
    del graph
    plain_ms = time_ms(lambda i: plain(*arg_sets[i % len(arg_sets)]))
    chain = count_cuda_launches(lambda: plain(*arg_sets[0]))
    nbytes, imads = KERNELS[key][3](*dims)
    b_ms, b_by = bound(nbytes, imads)
    log(f"{tag} {key} {KERNELS[key][0]} at {shape} ({what}): exact; kernel "
        f"{ms:.4f} ms (graph of {GRAPH_CALLS}), plain {plain_ms:.4f} ms in "
        f"{chain} launches; bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f}"
        f" MB, {imads / 1e6:.1f} M IMAD) = {100 * b_ms / ms:.0f}% of "
        f"roofline; {launch_text(key, dims)}")
    row.update(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
               plain_launches=chain)
    return row


def kernel_table(rows: list, launches: dict) -> list:
    """The JSON line's row per kernel: what it is, its launches in each
    phase (`launches`: {column: {kernel: count}}) and its kernel_rows'
    figures by phase and shape."""
    table = {}
    for r in rows:
        k = r["kernel"]
        name, src, repl, _ = KERNELS[k]
        t = table.setdefault(k, {
            "name": f"{k} {name}", "source": src, "replaces": repl,
            **{c: v[k] for c, v in launches.items()}, "by_shape": {}})
        t["by_shape"][f"{r['phase']} {r['shape']} {r['what']}"] = {
            f: v for f, v in r.items()
            if f not in ("kernel", "phase", "shape", "what")}
    return list(table.values())


def ntt_rows(t, xs, what: str, tag: str) -> list:
    """K3 and K4 on tables t over the input sets xs (each [L, n]) through
    kernel_row, and K4(K3(x)) == x."""
    import torch
    from ace_tpu_torch.ops import ntt, ntt4
    rows = [kernel_row(k, f, p, [(x, t) for x in xs], tuple(xs[0].shape),
                       what, tag)
            for k, f, p in (("K3", ntt4.ntt4_fwd, ntt.ntt_fwd_plain),
                            ("K4", ntt4.ntt4_inv, ntt.ntt_inv_plain))]
    if not torch.equal(ntt4.ntt4_inv(ntt4.ntt4_fwd(xs[0], t), t), xs[0]):
        raise AssertionError(f"{tag} K4(K3(x)) != x at "
                             f"{list(xs[0].shape)} ({what})")
    return rows


def chain_rows(crt, limbs, what: str, tag: str, rng) -> list:
    """K1-K4 over the limbs `limbs` of crt through kernel_row, on 4 input
    sets of uniform residues (K2 by per-limb constants)."""
    from ace_tpu_torch.ops import modops, pallas_modops as pm
    limbs = list(limbs)
    primes = [crt.all_primes[r] for r in limbs]
    dims = (len(limbs), crt.degree)
    xs = residue_sets(primes, crt.degree, crt.device, rng)
    ys = residue_sets(primes, crt.degree, crt.device, rng)
    q, mu_hi, mu_lo = crt.mod_arrays(limbs)
    ws = [int(rng.integers(1, p)) for p in primes]
    w = crt.column(ws)
    wp = crt.column([modops.precompute_shoup(v, p)
                     for v, p in zip(ws, primes)])
    return [kernel_row("K1", pm.barrett_mul, modops.barrett_mul,
                       [(x, y, q, mu_hi, mu_lo) for x, y in zip(xs, ys)],
                       dims, what, tag),
            kernel_row("K2", pm.shoup_mul, modops.shoup_mul,
                       [(x, w, wp, q) for x in xs], dims, what, tag)] \
        + ntt_rows(crt.tables_for(limbs), xs, what, tag)


def k5_rows(crt, level: int = NUM_Q) -> list:
    """K5 through kernel_row at the key switch's conversions at `level`
    live q limbs: digit 0's mod-up (12 -> 34 at the top level) and
    mod-down's 12 P -> 34 q."""
    from ace_tpu_torch.ops import baseconv, modops
    rng = np.random.default_rng(SEED + 5)
    sz = len(crt.parts[0])
    compl = crt.compl_indices[level - 1][0]
    m = crt.part_hat_mod_compl[level - 1][0]
    convs = {
        f"mod-up {sz} -> {len(compl)}": (
            crt.parts[0][:sz], [crt.all_primes[g] for g in compl],
            crt.part_hat_inv_mod_q[0][sz - 1],
            [[m[i][j] for i in range(sz)] for j in range(len(compl))]),
        f"mod-down {crt.num_p} P -> {level} q": (
            crt.p_primes, crt.q_primes[:level], crt.p_hat_inv_mod_p,
            crt.p_hat_mod_q[:level]),
    }
    rows = []
    for what, conv in convs.items():
        old, new = conv[:2]
        consts = modops.to_torch(baseconv.constants(*conv), crt.device)
        xs = residue_sets(old, crt.degree, crt.device, rng)
        rows.append(kernel_row(
            "K5", baseconv.base_conv, baseconv.base_conv_plain,
            [(x, consts, len(new)) for x in xs],
            (len(old), len(new), crt.degree), what, "[phase 2]"))
    return rows


K6_SHAPES = ((12, 22), (8, 46))  # (messages, limbs) at N = DEGREE


def k6_rows(crt) -> list:
    """K6 through kernel_row at the bundles' shapes [R, LK, N]: a conv
    bundle's 12 messages at level 10 (22 limbs) and a BSGS level's 8 at
    the top (46), on messages over the whole int64 range with 0, -1 and
    its two extremes among them."""
    import torch
    from ace_tpu_torch.ops import lift
    rng = np.random.default_rng(SEED + 6)
    n = crt.degree
    rows = []
    for R, LK in K6_SHAPES:
        idx = list(range(LK - crt.num_p)) + list(
            range(crt.num_q, crt.num_q + crt.num_p))
        qk, muh, mulo = crt.mod_arrays(idx)
        xs = [torch.as_tensor(rng.integers(-(1 << 62), 1 << 62, (R, n)),
                              device=crt.device) for _ in range(4)]
        xs[0][0, :4] = torch.tensor([0, -1, -(1 << 63), (1 << 63) - 1])
        rows.append(kernel_row(
            "K6", lift.lift_msgs, lift.lift_msgs_plain,
            [(x, qk, muh, mulo) for x in xs], (R, LK, n),
            "a conv bundle" if LK < 46 else "a BSGS level", "[phase 2]"))
    return rows


def count_cuda_launches(fn) -> int:
    """Device kernels one call of fn launches, read from torch.profiler
    (0 where the profiler records nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def ntt_shape(L: int, n: int) -> str:
    from ace_tpu_torch.ops import ntt4
    s = ntt4.launch_shape(L, n)
    return (f"1 launch, grid {s['blocks']} blocks = {L} clusters of "
            f"{s['cluster']} x {s['threads']} threads, "
            f"{s['smem_bytes'] // 1024} KB dynamic smem per block, "
            f"{s['resident_k3']}/{s['resident_k4']} clusters resident at "
            f"once (K3/K4)")


# ---------------------------------------------------------------------------
# Phase 3: whole ops, card against CPU
# ---------------------------------------------------------------------------

def phase_ops_exact() -> None:
    import torch
    from ace_tpu_torch.ckks.encoder import Encoder
    from ace_tpu_torch.ckks.evaluator import Evaluator
    from ace_tpu_torch.ckks.keygen import KeyGenerator
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.utils.csprng import Blake2Csprng

    kw = dict(degree=DEGREE, num_q=NUM_Q, first_mod_size=60,
              scaling_mod_size=56, hamming_weight=192, num_q_parts=Q_PARTS)
    t0 = time.perf_counter()
    pg = CkksParams(**kw, device="cuda")
    kg = KeyGenerator(pg, Blake2Csprng(SEED))
    enc = Encoder(pg)
    ev = Evaluator(pg, kg, enc)
    rot = 1
    rng = np.random.default_rng(SEED + 1)
    m = rng.uniform(-1, 1, DEGREE // 2)
    ct = ev.encrypt(enc.encode(m.astype(np.complex128)))
    assert ct.level == NUM_Q
    rot_g = ev.rotate(ct, rot)
    mul_g = ev.rescale(ev.mul(ct, ct))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu_replay(kw, kg, ct, rot, rot_g, mul_g, "[phase 3]")
    dec = enc.decode(ev.decrypt(rot_g)).real
    err = float(np.max(np.abs(dec - np.roll(m, -rot))))
    if not err < 1e-3:
        raise AssertionError(f"rotate decodes with error {err}")
    log(f"[phase 3] card {t_gpu:.1f} s (keys + ops), CPU "
        f"{time.perf_counter() - t0:.1f} s; rotate decodes to "
        f"roll(m, -1) within {err:.2e}")


def cpu_replay(kw, kg, ct, rot, rot_g, mul_g, tag) -> None:
    """rotate(ct, rot) and rescale(mul(ct, ct)) again on the CPU (plain
    versions), with kg's secret, relinearization and rotation keys and ct
    copied from the device; each must equal the device's result (rot_g,
    mul_g) residue for residue."""
    from ace_tpu_torch import interop
    from ace_tpu_torch.ckks.encoder import Encoder
    from ace_tpu_torch.ckks.evaluator import Evaluator
    from ace_tpu_torch.ckks.params import CkksParams

    auto_idx, rkey = kg.rot_key(rot)
    pc = CkksParams(**kw, device="cpu")
    npk = interop.to_numpy
    ckg = interop.keygen(
        pc, kg.sk.coeffs, npk(kg.sk.ntt_sk), npk(kg.pk.b), npk(kg.pk.a),
        ([npk(p) for p in kg.relin_key.b], [npk(p) for p in kg.relin_key.a]),
        {rot: (auto_idx, [npk(p) for p in rkey.b],
               [npk(p) for p in rkey.a])})
    cev = Evaluator(pc, ckg, Encoder(pc))
    cct = interop.ciphertext(npk(ct.c0), npk(ct.c1), ct.scaling_factor,
                             ct.sf_degree, ct.slots, "cpu")
    for what, g, c in (("rotate", rot_g, cev.rotate(cct, rot)),
                       ("mul+rescale", mul_g,
                        cev.rescale(cev.mul(cct, cct)))):
        for part in ("c0", "c1"):
            a, b = npk(getattr(g, part)), npk(getattr(c, part))
            if a.shape != b.shape or (a != b).any():
                raise AssertionError(f"{what}.{part}: card and CPU differ")
        log(f"{tag} {what} at level {ct.level}: card == CPU, "
            f"residue for residue")


# ---------------------------------------------------------------------------
# Phase 4: ResNet-20's first residual block, encrypted
# ---------------------------------------------------------------------------

def slice_model() -> dict:
    """Phase 4's model: ResNet-20's ops[:6] with its calibrated ReLU
    ranges, the scheme select_params picks with the chain set to 34 q
    primes, and the seeded input. Phase 9b runs it again."""
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import (SchemeConfig,
                                                    select_params)
    from ace_tpu_torch.models import resnet as M

    g = M.build_resnet_cifar(3)
    g.ops = g.ops[:6]
    g.output_name = g.ops[-1].outputs[0]
    assert g.output_name == "/layer1/layer1.0/Add_output_0"
    img = np.random.default_rng(0).uniform(-1.5, 1.5, (1, 3, 32, 32))[0]
    vr_default, vr = ranges_for("resnet20_cifar10")
    vr_default, vr = M.calibrate_relu_ranges(g, [img], vr_default, vr,
                                             trace=log)
    cfg = SchemeConfig(security_level=0, hamming_weight=192,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=9, relu_value_range=vr_default,
                       relu_ranges=vr, use_bootstrap=False)
    info = select_params(g, cfg)
    log(f"[phase 4] select_params: N={info.poly_degree} "
        f"mul_level={info.mul_level} input_level={info.input_level}; "
        f"mul_level set to {NUM_Q - 1}")
    info.mul_level = NUM_Q - 1
    return {"graph": g, "cfg": cfg, "info": info, "img": img,
            "out_len": 16 * 32 * 32}


def phase_slice(sm: dict) -> dict:
    """Phase 4 on slice_model()'s model: cold (keys made on demand), then
    warm. Returns the first inference's output residues for phase 9b,
    and the model and that inference's input ciphertext for phase 11d."""
    import torch
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.ops import (modops, read_counters, read_limbs,
                                   reset_counters)
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.runtime.timing import TIMING

    TIMING.enabled = True
    g, img, out_len = sm["graph"], sm["img"], sm["out_len"]
    t0 = time.perf_counter()
    ctx = FheContext(scheme_info=sm["info"], max_rot_keys=100)
    torch.cuda.synchronize()
    t_ctx = time.perf_counter() - t0
    crt = ctx.params.crt
    log(f"[phase 4] context {t_ctx:.1f} s: N={ctx.params.degree}, "
        f"{crt.num_q} q primes + {crt.num_p} P primes, "
        f"{ctx.params.num_q_parts} digits")
    model = M.compile_model(g, sm["cfg"], ctx=ctx, num_classes=out_len,
                            trace=log)

    reset_counters()
    TIMING.reset()
    t0 = time.perf_counter()
    out = M.infer_encrypted(model, img)
    torch.cuda.synchronize()
    t_inf = time.perf_counter() - t0
    launches = read_counters()
    limbs = read_limbs()
    ct_in = ctx.get_input_data("input")
    ct = ctx.get_output_data("output")
    residues = (modops.to_numpy(ct.c0.data), modops.to_numpy(ct.c1.data))
    t_keys = TIMING.seconds("RTM_ROT_KEY_REGEN")
    log(f"[phase 4] inference {t_inf:.1f} s, of which rotation-key "
        f"generation {t_keys:.1f} s ({TIMING.count('RTM_ROT_KEY_REGEN')} "
        f"keys); launches {launches}; NTT limbs {limbs} (mean "
        + ", ".join(f"{k} {limbs[k] / max(launches[k], 1):.1f}"
                    for k in limbs) + " limbs per launch); output at "
        f"level {ct.level}")
    log(TIMING.report())

    t0 = time.perf_counter()
    out2 = M.infer_encrypted(model, img)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"[phase 4] second inference (keys held) {t_warm:.1f} s")

    plain = M.infer_plain(g, img, n_slots=DEGREE // 2)[:out_len]
    scale = float(np.max(np.abs(plain)))
    errs = [float(np.max(np.abs(o - plain))) for o in (out, out2)]
    log(f"[phase 4] max_err {errs[0]:.4e} (second run {errs[1]:.4e}), "
        f"max|plain| {scale:.4f}, limit 5e-2 * max|plain| = "
        f"{5e-2 * scale:.4e}")
    log(f"[phase 4] {ctx.hbm_plan()}")
    log(f"[phase 4] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(np.all(np.isfinite(o)) and o.shape == (out_len,)
               for o in (out, out2)):
        raise AssertionError("output is not finite or has the wrong shape")
    if not max(errs) <= 5e-2 * scale:
        raise AssertionError(f"max_err {max(errs)} > 5e-2 * {scale}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched in the slice: {idle}")
    log(f"[phase 4] op programs: {ctx.evaluator.program_stats()}")
    return {"launches": launches, "context_s": t_ctx, "inference_s": t_inf,
            "rot_keygen_s": t_keys, "warm_inference_s": t_warm,
            "max_err": errs[0], "max_plain": scale, "residues": residues,
            "model": model, "input": ct_in}


def profile_inference(run, unprofiled_s: float, tag: str,
                      device="cuda", stats: dict | None = None):
    """One more warm run under torch.profiler: kernel time by name and
    the device's busy share. The profiler records the device's activity
    only (no CPU op events, which a run of a million launches takes
    minutes to stop and read) and still slows the host, so the busy
    share is given both over the profiled wall time (the idle share of
    that run) and over `unprofiled_s`, the wall time of an unprofiled
    warm run (a rough figure for a real one). The run always happens,
    any failure of it fails the phase, and its output is returned for
    the phase's check; only a profiler that cannot start or reports
    nothing is logged as not measured. `stats`, if given, receives the
    profiled run's wall and kernel-busy seconds and its idle share."""
    import contextlib
    import torch
    from ace_tpu_torch.utils.card import syncer
    stack = contextlib.ExitStack()
    prof = None
    on_card = torch.device(device).type == "cuda"
    try:
        from torch.profiler import ProfilerActivity, profile
        prof = stack.enter_context(profile(activities=[
            ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]))
    except Exception as exc:  # noqa: BLE001 — the profiler alone
        log(f"{tag} profiler did not start, not measured: {exc!r}")
    with stack:
        t0 = time.perf_counter()
        out = run()
        syncer(device)()
        wall = time.perf_counter() - t0
    t_stop = time.perf_counter() - t0 - wall
    if prof is None:
        return out
    try:
        import collections
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        # device events straight from the profiler's raw (kineto) events:
        # key_averages() would first build a Python tree over every
        # runtime call, minutes for a run of a million launches
        dev_ns, calls = collections.Counter(), collections.Counter()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                dev_ns[e.name()] += e.duration_ns()
                calls[e.name()] += 1
        t_read = time.perf_counter() - t0
    except Exception as exc:  # noqa: BLE001 — the profiler's report alone
        log(f"{tag} profile unreadable, not measured: {exc!r}")
        return out
    if not dev_ns:
        log(f"{tag} profile: no device time recorded (not measured)")
        return out
    busy = sum(dev_ns.values()) / 1e9
    if stats is not None:
        stats.update(wall_s=wall, busy_s=busy, idle=1 - busy / wall)
    log(f"{tag} profiled warm run {wall:.2f} s wall, kernels busy "
        f"{busy:.2f} s: idle {100 * (1 - busy / wall):.0f}% of the profiled "
        f"run; busy {100 * busy / unprofiled_s:.0f}% of the unprofiled "
        f"warm run's {unprofiled_s:.2f} s (rough); profiler stopped in "
        f"{t_stop:.1f} s, {sum(calls.values())} device events read in "
        f"{t_read:.1f} s")
    for name, ns in dev_ns.most_common(15):
        log(f"{tag}   {ns / 1e6:10.2f} ms {calls[name]:7d}x  {name[:90]}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: one bootstrap at full parameters
# ---------------------------------------------------------------------------

def phase_bootstrap() -> dict:
    """tests/test_bootstrap.py at ResNet-20's ring: uniform(-0.7, 0.7) in
    N/2 slots encrypted at level 2, bootstrapped through
    FheContext.bootstrap cold (the bootstrap tables and its 91 rotation
    keys and the conjugation key made on demand), then warm. Each output
    must regain levels and decode within 2e-2 (that test's bound); every
    kernel's counter must grow. Returns the context, the input and its
    message for phase 11c."""
    import torch
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.ops import read_counters, reset_counters
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.runtime.timing import TIMING

    TIMING.enabled = True
    TIMING.reset()
    params = CkksParams(degree=DEGREE, num_q=NUM_Q, first_mod_size=60,
                        scaling_mod_size=56, hamming_weight=192,
                        num_q_parts=Q_PARTS, device="cuda")
    ctx = FheContext(params, seed=SEED)
    msg = np.random.default_rng(SEED + 5).uniform(-0.7, 0.7, DEGREE // 2)
    ct = ctx.evaluator.encrypt(ctx.encoder.encode(
        msg.astype(np.complex128), level=2))
    assert ct.level == 2

    def run():
        out = ctx.bootstrap(ct)
        torch.cuda.synchronize()
        return out

    reset_counters()
    t0 = time.perf_counter()
    outs = [run()]
    t_cold = time.perf_counter() - t0
    launches = read_counters()
    log(f"[phase 5] cold bootstrap {t_cold:.2f} s: tables "
        f"{TIMING.seconds('RTM_BS_SETUP'):.2f} s, "
        f"{TIMING.count('RTM_ROT_KEY_REGEN')} keys "
        f"{TIMING.seconds('RTM_ROT_KEY_REGEN'):.2f} s; launches {launches}")
    TIMING.reset()
    t0 = time.perf_counter()
    outs.append(run())
    t_warm = time.perf_counter() - t0
    log(f"[phase 5] warm bootstrap {t_warm:.2f} s")
    log(TIMING.report())
    errs = []
    for out in outs:
        ctx.set_output_data("bts", out)
        errs.append(float(np.max(np.abs(ctx.handle_output("bts") - msg))))
    log(f"[phase 5] level 2 -> {outs[0].level}, sf_degree "
        f"{outs[0].sf_degree}; max decode error {max(errs):.3e} over "
        f"{len(outs)} runs (limit 2e-2)")
    if not all(o.level > ct.level + 2 for o in outs):
        raise AssertionError(f"no levels gained: {[o.level for o in outs]}")
    if not max(errs) < 2e-2:
        raise AssertionError(f"bootstrap decodes with error {max(errs)}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched in the bootstrap: "
                             f"{idle}")
    return {"cold_s": t_cold, "warm_s": t_warm, "max_err": max(errs),
            "launches": launches, "ctx": ctx, "input": ct, "msg": msg}


# ---------------------------------------------------------------------------
# Phase 6: all of ResNet-20, bootstrapping before every ReLU
# ---------------------------------------------------------------------------

RESNET20_BOOTSTRAPS = 19  # one before each of its 19 ReLUs


def phase_resnet20(device=None, graph=None, img=None,
                   name: str = "resnet20_cifar10",
                   bootstraps: int = RESNET20_BOOTSTRAPS,
                   **scheme) -> dict:
    """build_resnet_cifar(3), every op, through the model zoo's path
    (scripts/torch_zoo.py): cfg_for on phase 4's image (the tuned ranges
    of resnet20_cifar10 calibrated on it, relu depth 9), select_params
    with use_bootstrap=True (no forced mul_level; the input at
    scheme.input_level), shared_context (the key LRU sized from the
    byte budget) and run_model (compile_model, then measured_infer,
    which sets the kernel counters to 0 just before infer_encrypted and
    reads them, the keys and the timing buckets just after): one cold
    inference (keys made on demand; the warm rerun of earlier versions
    was cut to keep the script within its time limit once phase 8
    came). Gates (torch_zoo.gate_failures on the zoo's row): finite
    logits of shape (classes,), max_err <= 0.1 * max|plain|,
    `bootstraps` bootstraps; and argmax equal to infer_plain's. main()
    holds the launch gate. device, graph, img, name, bootstraps and
    `scheme` (cfg_for's scheme sizes) let the CPU run it at a tiny
    size."""
    import torch
    from ace_tpu_torch.compiler.scheme_info import select_params
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.timing import TIMING
    from ace_tpu_torch.utils.card import syncer
    from ace_tpu_torch.utils.scripts import load_script

    zoo = load_script("torch_zoo")
    gpu = device is None or torch.device(device).type == "cuda"
    TIMING.enabled = True
    if gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    g = graph if graph is not None else M.build_resnet_cifar(3)
    if img is None:
        img = np.random.default_rng(0).uniform(-1.5, 1.5,
                                               (1, 3, 32, 32))[0]
    classes = zoo.classes_of(name)
    t0 = time.perf_counter()
    cfg = zoo.cfg_for(name, g, [img], relu_depth=9, **scheme)
    si = select_params(g, cfg)
    _, ctx = zoo.shared_context({name: si}, device=device)
    syncer(device or "cuda")()
    t_ctx = time.perf_counter() - t0
    crt = ctx.params.crt
    log(f"[phase 6] {len(g.ops)} ops; select_params: N={si.poly_degree} "
        f"mul_level={si.mul_level} input_level={si.input_level} "
        f"bootstrap_depth={si.bootstrap_depth}; {crt.num_q} q + "
        f"{crt.num_p} P primes, {ctx.params.num_q_parts} digits; "
        f"context {t_ctx:.1f} s")

    row = zoo.run_model(name, g, cfg, ctx, [img], classes, trace=log)[0]
    st = row["stats"]
    t_setup = st["timing"].get("RTM_BS_SETUP", [0, 0.0])[1]
    log(f"[phase 6] cold inference {row['seconds']:.1f} s, of which "
        f"{st['rotation_keys']} rotation keys "
        f"{st['rotation_key_seconds']:.1f} s and bootstrap tables "
        f"{t_setup:.1f} s; launches {st['launches']}; NTT limbs "
        f"{st['limbs']}")
    log(TIMING.report(st["timing"]))
    bundles = {k: st["timing"].get(f"CKKS::{k}", [0])[0]
               for k in ("rot_mac_groups_msgs_jit", "bsgs_iter_jit")}
    log(f"[phase 6] K6 launches an image {st['launches'].get('K6')} (one a "
        f"MAC group, replays included; the same in a warm image) over "
        f"bundle calls {bundles}")
    programs = ctx.evaluator.program_stats()
    log(f"[phase 6] op programs: {programs}")
    # allocated misses the graph pool's segments once the captures end
    # (replays use them without the allocator); reserved counts them
    peak = torch.cuda.max_memory_allocated() / 2**30 if gpu else 0.0
    reserved = torch.cuda.max_memory_reserved() / 2**30 if gpu else 0.0
    scale = st["max_plain"]
    log(f"[phase 6] logits "
        f"{np.array2string(np.array(st['logits']), precision=4)}")
    log(f"[phase 6] plain  "
        f"{np.array2string(np.array(st['plain_logits']), precision=4)}")
    log(f"[phase 6] max_err {row['max_err']:.4e}; max|plain| {scale:.4f}, "
        f"limit 0.1 * max|plain| = {0.1 * scale:.4e}; argmax agrees "
        f"{row['argmax_agree']}; bootstraps {st['bootstraps']}; "
        f"{st['rotation_keys_held']} rotation keys held; peak device "
        f"memory {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved "
        f"(graph pool included)")
    fails = zoo.gate_failures(row, classes, bootstraps, 0.1 * scale,
                              kernels=False)
    if not row["argmax_agree"]:
        fails.append("argmax disagrees with infer_plain")
    if fails:
        raise AssertionError("; ".join(fails))
    return {"launches": st["launches"], "cold_s": row["seconds"],
            "rot_keygen_s": st["rotation_key_seconds"],
            "keys": st["rotation_keys"], "max_err": row["max_err"],
            "max_plain": scale, "peak_gib": peak,
            "peak_reserved_gib": reserved,
            "bootstraps": st["bootstraps"], "programs": programs}


# ---------------------------------------------------------------------------
# Phase 7: the compile driver and runtime services
# ---------------------------------------------------------------------------

# Manifest rotation keys pre-warmed in phase 7 (the LRU's capacity too):
# at 0.1-0.35 s a key on an H100, under about 25 s of keygen, and room
# for every key of ops[:6] (the bit-exact resume needs them held).
PREWARM_KEYS = 64
# Ops of ResNet-20's ops[:6] run under the validator (epsilon 1e-2, every
# op checked); the ReLU's composite-sign error exceeds epsilon, so the
# validated prefix is the stem conv.
VALIDATED_OPS = 1
CKKS_FLAGS = "-CKKS:sk_hw=192:q0=60:sf=56:sec=0"


def write_onnx(g, path: str) -> None:
    """Write an NNGraph as an ONNX model with the port's generated
    bindings, as tests/test_frontend_hardening.py builds one: one node per
    op with its attributes, the weights as raw initializers in their own
    dtypes, the input with its shape. load_onnx gives the graph back."""
    from ace_tpu_torch.compiler.onnx_front import _onnx_pb2
    pb = _onnx_pb2()
    dtypes = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
              np.dtype(np.float64): 11}
    m = pb.ModelProto()
    gp = m.graph
    for op in g.ops:
        n = gp.node.add()
        n.op_type, n.name = op.op_type, op.name
        n.input.extend(op.inputs)
        n.output.extend(op.outputs)
        for k, v in op.attrs.items():
            a = n.attribute.add()
            a.name = k
            if isinstance(v, int):
                a.type, a.i = pb.AttributeProto.INT, v
            elif isinstance(v, float):
                a.type, a.f = pb.AttributeProto.FLOAT, v
            else:
                a.type = pb.AttributeProto.INTS
                a.ints.extend(int(x) for x in v)
    for name, arr in g.weights.items():
        arr = np.asarray(arr)
        t = gp.initializer.add()
        t.name, t.data_type = name, dtypes[arr.dtype]
        t.dims.extend(arr.shape)
        t.raw_data = arr.tobytes()
    vi = gp.input.add()
    vi.name = g.input_name
    for d in g.input_shape:
        vi.type.tensor_type.shape.dim.add().dim_value = d
    gp.output.add().name = g.output_name
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


def _prefix(g, k: int):
    from ace_tpu_torch.compiler.onnx_front import NNGraph
    return NNGraph(g.ops[:k], g.weights, g.input_name, g.input_shape,
                   g.ops[k - 1].outputs[0])


class _Interrupted(Exception):
    pass


def phase_runtime_services(g, img, vr_default: float, vr: dict,
                           device: str = "cuda", ckks_flags=CKKS_FLAGS,
                           prewarm_keys: int = PREWARM_KEYS,
                           validated_ops: int = VALIDATED_OPS,
                           expect=(DEGREE, NUM_Q - 1)) -> dict:
    """The CNN path's remaining entry points on graph g (ResNet-20 on the
    card; main() passes build_resnet_cifar(3) and phase 6's calibration):
      a. compile: g written as ONNX, then the compile driver
         (python -m ace_tpu_torch.driver) with the reference's flags and
         the calibrated ReLU ranges -> manifest + weight file; the
         manifest's scheme must equal select_params on the loaded graph;
      b. reload: FheContext.from_manifest, pre-warming prewarm_keys
         rotation keys; the weight file opened through the native loader;
         the first conv's weight from the manifest's weight file equal,
         residue for residue, to a direct encode at the top level;
      c. validated run (--rtt): compile_model(check_every=True) and
         infer_encrypted over ops[:validated_ops] (epsilon 1e-2 after
         every op); then an input ciphertext perturbed by an added
         constant must raise ValidationError;
      d. checkpoint resume: one encrypted input through ops[:6]
         uninterrupted; again with a checkpoint file and a crash during op
         4; a fresh GraphRunner resumes from the file, and its output must
         equal the uninterrupted one residue for residue;
      e. how many of the pre-warmed manifest keys c and d used.
    Returns the kernels' launches over c and d with the step metrics;
    main() fails unless every kernel launched. tests/test_torch_driver.py
    runs this phase on the CPU at a tiny size."""
    import copy
    import dataclasses
    import tempfile
    import torch
    from ace_tpu_torch import driver
    from ace_tpu_torch.ckks.bootstrap import bootstrap_rotation_indices
    from ace_tpu_torch.compiler.lowering import GraphRunner
    from ace_tpu_torch.compiler.onnx_front import load_onnx
    from ace_tpu_torch.compiler.scheme_info import (SchemeConfig,
                                                    select_params)
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.ops import read_counters, reset_counters
    from ace_tpu_torch.runtime import ckpt
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.runtime.timing import TIMING
    from ace_tpu_torch.runtime.validate import Shadow, ValidationError
    from ace_tpu_torch.utils.card import syncer

    sync = syncer(device)
    TIMING.enabled = True
    tag = "[phase 7]"
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # a. compile
        onnx = os.path.join(tmp, "model.onnx")
        wfile = os.path.join(tmp, "model.msg")
        mfile = os.path.join(tmp, "model.manifest.json")
        write_onnx(g, onnx)
        sihe = (f"-SIHE:relu_depth=9:relu_vr_def={vr_default!r}:relu_vr="
                + ";".join(f"{k}={v!r}" for k, v in vr.items()))
        t0 = time.perf_counter()
        rc = driver.main([onnx, ckks_flags, sihe, f"-P2C:df={wfile}", "-o",
                          mfile])
        res["compile_s"] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"compile driver returned {rc}")
        with open(mfile) as f:
            man = json.load(f)
        gl = load_onnx(onnx)
        if [dataclasses.asdict(o) for o in gl.ops] != \
                [dataclasses.asdict(o) for o in g.ops]:
            raise AssertionError("the ONNX file does not load back to g")
        cfg = SchemeConfig(**man["config"])
        want = dataclasses.asdict(select_params(gl, cfg))
        want["rotate_indices"] = list(want["rotate_indices"])
        if man["scheme"] != want:
            raise AssertionError(f"manifest scheme {man['scheme']} != "
                                 f"select_params {want}")
        si = man["scheme"]
        if (si["poly_degree"], si["mul_level"]) != expect:
            raise AssertionError(f"manifest N, mul_level "
                                 f"{si['poly_degree'], si['mul_level']} "
                                 f"!= {expect}")
        rots = man["rotate_indices"]
        if not rots:
            raise AssertionError("manifest lists no rotation")
        n_bts = len(set(rots) & set(bootstrap_rotation_indices(
            si["poly_degree"])))
        res["rotations"] = len(rots)
        log(f"{tag} a. compile driver {res['compile_s']:.2f} s: "
            f"{len(gl.ops)} ops, N={si['poly_degree']} "
            f"mul_level={si['mul_level']} input_level={si['input_level']}; "
            f"{len(rots)} rotation indices ({n_bts} from "
            f"bootstrap_rotation_indices); weight file "
            f"{os.path.getsize(wfile)} bytes, manifest == select_params")

        # b. reload from the manifest
        TIMING.reset()
        t0 = time.perf_counter()
        ctx = FheContext.from_manifest(mfile, max_rot_keys=prewarm_keys,
                                       device=device)
        sync()
        res["context_s"] = time.perf_counter() - t0
        n_keys = TIMING.count("RTM_ROT_KEY_REGEN")
        t_keys = TIMING.seconds("RTM_ROT_KEY_REGEN")
        res["s_per_key"] = t_keys / max(n_keys, 1)
        prewarmed = set(ctx.keygen._rot_keys)
        mgr = ctx.pt_mgr
        if mgr is None or mgr.bio_engine == "mmap":
            raise AssertionError("the weight file did not open through the "
                                 "native loader")
        res["bio_engine"] = mgr.bio_engine
        wname = g.ops[0].inputs[1]
        top = ctx.params.num_q
        mgr.prefetch(wname)
        t0 = time.perf_counter()
        got = mgr.get(wname, top)
        sync()
        t_get = time.perf_counter() - t0
        w = gl.weights[wname].reshape(-1)
        msg = np.zeros(ctx.params.degree // 2, np.complex128)
        msg[:w.size] = w
        ref = ctx.encoder.encode(msg, level=top)
        if got.poly.data.device.type != ctx.device.type:
            raise AssertionError(f"weight-file plaintext on "
                                 f"{got.poly.data.device}, not {ctx.device}")
        if not torch.equal(got.poly.data, ref.poly.data):
            raise AssertionError(f"weight-file plaintext {wname} differs "
                                 f"from encode")
        log(f"{tag} b. from_manifest {res['context_s']:.2f} s on "
            f"{ctx.device}: {n_keys} keys pre-warmed in {t_keys:.2f} s "
            f"({res['s_per_key']:.3f} s a key); weight file through the "
            f"native loader ({mgr.bio_engine}); {wname} at level {top} "
            f"({w.size} values, prefetched, get {t_get:.3f} s) == encode, "
            f"residue for residue")

        # c. validated run, then a perturbed input
        used = set()
        auto_key = ctx.keygen._auto_key

        def spy(ai):
            used.add(ai)
            return auto_key(ai)
        ctx.keygen._auto_key = spy
        reset_counters()
        cfg6 = dataclasses.replace(cfg, use_bootstrap=False)
        gv = _prefix(gl, validated_ops)
        out_len = int(np.prod(gv.ops[-1].out_shape))
        vmodel = M.compile_model(gv, cfg6, ctx=ctx, num_classes=out_len,
                                 check_every=True)
        vbe = vmodel.runner.be
        t0 = time.perf_counter()
        out_v = M.infer_encrypted(vmodel, img)
        sync()
        res["validated_s"] = time.perf_counter() - t0
        res["checks"] = vbe._op_count + 1  # every op, and the output
        plain = M.infer_plain(gv, img, n_slots=vbe.n_slots)[:out_len]
        err = float(np.max(np.abs(out_v - plain)))
        log(f"{tag} c. validated ops[:{validated_ops}] ("
            f"{', '.join(o.op_type for o in gv.ops)}): {res['checks']} "
            f"checks within epsilon {vbe.epsilon} in "
            f"{res['validated_s']:.2f} s; output max_err {err:.3e}")
        ct = ctx.prepare_input(img, "input", level=vmodel.scheme.input_level)
        smsg = np.zeros(vbe.n_slots)
        smsg[:img.size] = np.asarray(img, np.float64).reshape(-1)
        bad = Shadow(ctx.evaluator.add_const(ct, 0.05), smsg)
        try:
            vmodel.runner.run(bad)
        except ValidationError as exc:
            log(f"{tag} c. input + 0.05: ValidationError: {exc}")
        else:
            raise AssertionError("a perturbed ciphertext passed validation")

        # d. checkpoint resume
        g6 = _prefix(gl, 6)
        out_len = int(np.prod(g6.ops[-1].out_shape))
        model = M.compile_model(g6, cfg6, ctx=ctx, num_classes=out_len)
        ct = ctx.prepare_input(img, "input", level=model.scheme.input_level)
        t0 = time.perf_counter()
        full = model.runner.run(ct)
        sync()
        t_full = time.perf_counter() - t0
        ck = os.path.join(tmp, "ops6.npz")

        def crash_in_op4(msg):
            if msg.startswith("[4/"):
                raise _Interrupted
        first = copy.copy(model.runner)
        first.trace = crash_in_op4
        try:
            first.run(ct, checkpoint=ck)
        except _Interrupted:
            pass
        else:
            raise AssertionError("the run was not interrupted")
        res["ckpt_bytes"] = os.path.getsize(ck)
        t0 = time.perf_counter()
        env, nxt = ckpt.load(ck, ctx.device)
        sync()
        res["ckpt_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.save(os.path.join(tmp, "copy.npz"), env, nxt)
        res["ckpt_save_s"] = time.perf_counter() - t0
        if nxt != 3:
            raise AssertionError(f"checkpoint at op {nxt}, expected 3")
        r = model.runner
        fresh = GraphRunner(g6, r.be, relu_ranges=r.relu_ranges,
                            relu_range_default=r.relu_range_default,
                            relu_mul_depth=r.relu_mul_depth)
        t0 = time.perf_counter()
        out = fresh.run(ct, checkpoint=ck)
        sync()
        t_res = time.perf_counter() - t0
        if not all(torch.equal(getattr(out, c).data, getattr(full, c).data)
                   for c in ("c0", "c1")):
            raise AssertionError("resumed ops[:6] differs from the "
                                 "uninterrupted run")
        ctx.set_output_data("resumed", out)
        dec = ctx.handle_output("resumed", out_len)
        plain = M.infer_plain(g6, img, n_slots=vbe.n_slots)[:out_len]
        err = float(np.max(np.abs(dec - plain)))
        scale = float(np.max(np.abs(plain)))
        if not err <= 5e-2 * scale:
            raise AssertionError(f"resumed output max_err {err} > 5e-2 * "
                                 f"{scale}")
        log(f"{tag} d. ops[:6] uninterrupted {t_full:.2f} s; crashed in op "
            f"4, checkpoint after op {nxt}: {res['ckpt_bytes']} bytes "
            f"({len(env)} ciphertexts), load {res['ckpt_load_s']:.3f} s, "
            f"save {res['ckpt_save_s']:.3f} s; resumed ops 4-6 in "
            f"{t_res:.2f} s == uninterrupted, residue for residue; max_err "
            f"{err:.3e} of max|plain| {scale:.3f}")
        launches = read_counters()
        res["launches"] = launches

        # e. manifest key hits
        hits = prewarmed & used
        res["key_hits"] = len(hits)
        log(f"{tag} e. manifest keys: {len(prewarmed)} pre-warmed, "
            f"{len(used)} used by c and d, {len(hits)} of them pre-warmed, "
            f"{len(used - prewarmed)} made on demand; launches over c and "
            f"d {launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 8: one encrypted LLaMA attention block at full head width
# ---------------------------------------------------------------------------

# One head of models/llama.py's block (EMBED 4096 over 32 heads: d = 128),
# seq * d = N/2 at N = 2^15, on tests/test_llama_fhe.py's chain.
ATTN_SEQ, ATTN_D, ATTN_NUM_Q = 128, 128, 50
ATTN_TOL = 2e-2  # tests/test_llama_fhe.py's bound


def attention_data(seq: int, d: int, seed: int = SEED):
    """Weights, input and certified data ranges for one attention block,
    drawn as tests/test_llama_fhe.py draws them, from default_rng(seed).
    The projections are scaled by sqrt(8 / d) so that q.k/sqrt(d) spreads
    as at that test's D = 8. The ranges come from the plain shadow, as
    that test certifies them (the relu_vr analog)."""
    rng = np.random.default_rng(seed)
    s = 0.35 * np.sqrt(8 / d)
    w = {"rms_weight": rng.uniform(0.6, 1.4, d),
         "wq": rng.standard_normal((d, d)) * s,
         "wk": rng.standard_normal((d, d)) * s,
         "wv": rng.standard_normal((d, d)) * s}
    x = rng.standard_normal((seq, d)) * 0.8
    ms = np.mean(x * x, axis=-1) + 1e-5
    y = x / np.sqrt(ms)[:, None] * np.asarray(w["rms_weight"])
    q = y @ w["wq"].T
    k = y @ w["wk"].T
    smax = float(np.max(np.abs(q @ k.T)) / np.sqrt(d) * 1.3 + 0.5)
    den = np.exp((q @ k.T) / np.sqrt(d)).sum(-1)
    ranges = dict(ms_range=(float(ms.min()) * 0.7, float(ms.max()) * 1.4),
                  score_bound=smax,
                  den_range=(float(den.min()) * 0.7, float(den.max()) * 1.4))
    return w, x, ranges


class _BlockProbe:
    """Counts and stage marks for one encrypted_attention call, taken
    without changing the port's code: the evaluator's rotate and
    mul_plain and the encoder's encode (called by encode_cached on a miss
    only) are counted on the instances, and the llama_fhe helpers and
    nonlinear functions that open and close the block's stages are
    wrapped for the duration of the `with` block to record a mark (wall
    clock with the device synchronized, the rotation keys made so far,
    the counts) on entry and exit."""

    STAGES = (("rmsnorm", "start", "_matmul_plain_w#1<"),
              ("projections", "_matmul_plain_w#1<", "_matmul_plain_w#3>"),
              ("rope", "_matmul_plain_w#3>", "_rope#2>"),
              ("scores", "_rope#2>", "exp#1<"),
              ("softmax", "exp#1<", "reciprocal#1>"),
              ("output", "reciprocal#1>", "end"))

    def __init__(self, ev, enc, sync):
        self.counts = {"rotate": 0, "mul_plain": 0, "encode": 0}
        self.marks = {}
        self.first_projection = None  # (input, output) of the q projection
        self._sync = sync
        for obj, name in ((ev, "rotate"), (ev, "mul_plain"),
                          (enc, "encode")):
            setattr(obj, name, self._counted(getattr(obj, name), name))

    def _counted(self, f, name):
        def g(*a, **k):
            self.counts[name] += 1
            return f(*a, **k)
        return g

    def mark(self, label: str) -> None:
        from ace_tpu_torch.runtime.timing import TIMING
        self._sync()
        self.marks[label] = dict(
            t=time.perf_counter(),
            keys=TIMING.count("RTM_ROT_KEY_REGEN"),
            keys_s=TIMING.seconds("RTM_ROT_KEY_REGEN"), **self.counts)

    def __enter__(self):
        from ace_tpu_torch.ckks import nonlinear as NL
        from ace_tpu_torch.models import llama_fhe as LF
        self._saved = []
        calls = {}
        for mod, name in ((LF, "_matmul_plain_w"), (LF, "_rope"),
                          (NL, "exp"), (NL, "reciprocal")):
            f = getattr(mod, name)
            self._saved.append((mod, name, f))

            def g(*a, _f=f, _name=name, **k):
                calls[_name] = i = calls.get(_name, 0) + 1
                self.mark(f"{_name}#{i}<")
                out = _f(*a, **k)
                self.mark(f"{_name}#{i}>")
                if _name == "_matmul_plain_w" and i == 1:
                    self.first_projection = (a[2], out)
                return out
            setattr(mod, name, g)
        self.mark("start")
        return self

    def __exit__(self, *exc):
        for mod, name, f in self._saved:
            setattr(mod, name, f)
        if exc[0] is None:
            self.mark("end")

    def stages(self) -> list:
        """(stage, seconds, keys made, key seconds, rotations, mul_plain,
        encodes) per stage."""
        out = []
        for stage, a, b in self.STAGES:
            m0, m1 = self.marks[a], self.marks[b]
            out.append((stage, m1["t"] - m0["t"], m1["keys"] - m0["keys"],
                        m1["keys_s"] - m0["keys_s"],
                        m1["rotate"] - m0["rotate"],
                        m1["mul_plain"] - m0["mul_plain"],
                        m1["encode"] - m0["encode"]))
        return out


def phase_attention(device=None, seq: int = ATTN_SEQ, d: int = ATTN_D,
                    num_q: int = ATTN_NUM_Q) -> dict:
    """One head of the LLaMA attention block encrypted through the port's
    models/llama_fhe.encrypted_attention, at CkksParams(degree=2*seq*d,
    num_q, 60, 50), the chain tests/test_llama_fhe.py uses:
      a. K1-K4 at this chain's shapes, the extended basis
         [num_q + num_p, N] and the q chain [num_q, N], through
         kernel_row (equal to their plain versions; timed on the card);
         one rotate and one mul+rescale at the top level equal on the
         device and on the CPU;
      b. the block cold (every rotation key made on demand, the LRU
         unbounded) on attention_data's input, stage by stage; decoded
         within ATTN_TOL of attention_plain, finite;
      c. the block's q projection again on its own input, keys held,
         under torch.profiler; it must equal the block's residue for
         residue.
    Returns the kernels' launches during b with the block's metrics and
    a's kernel rows;
    main() fails unless every kernel launched. device=None is the card;
    tests/test_torch_llama.py runs this phase on the CPU at seq = 4,
    d = 8."""
    import gc
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.ckks.encoder import Encoder
    from ace_tpu_torch.ckks.evaluator import Evaluator
    from ace_tpu_torch.ckks.keygen import KeyGenerator
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.models import llama_fhe as LF
    from ace_tpu_torch.ops import read_counters, read_limbs, reset_counters
    from ace_tpu_torch.runtime.timing import TIMING
    from ace_tpu_torch.utils.card import syncer

    dev = resolve_device(device)
    sync = syncer(dev)
    on_card = dev.type == "cuda"
    tag = "[phase 8]"
    TIMING.enabled = True
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    res = {}

    # a. the kernels and two ops at this chain's shapes
    kw = dict(degree=2 * seq * d, num_q=num_q, first_mod_size=60,
              scaling_mod_size=50)
    t0 = time.perf_counter()
    params = CkksParams(**kw, device=dev)
    crt = params.crt
    # keys from 256 bits of os.urandom (Blake2Csprng's default seed)
    kg = KeyGenerator(params, max_rot_keys=0)
    enc = Encoder(params)
    ev = Evaluator(params, kg, enc)
    sync()
    t_ctx = time.perf_counter() - t0
    log(f"{tag} N = {params.degree}, seq = {seq}, d = {d}: {crt.num_q} q "
        f"primes + {crt.num_p} P primes, {params.num_q_parts} digits; "
        f"context and keys {t_ctx:.1f} s")
    rng = np.random.default_rng(SEED + crt.num_q)
    res["kernel_rows"] = chain_rows(crt, range(crt.num_q + crt.num_p),
                                    "the extended basis", tag, rng) \
        + chain_rows(crt, range(crt.num_q), "the q chain", tag, rng)
    w, x, ranges = attention_data(seq, d)
    ct = ev.encrypt(enc.encode(x.reshape(-1).astype(np.complex128)))
    t0 = time.perf_counter()
    cpu_replay(kw, kg, ct, 1, ev.rotate(ct, 1), ev.rescale(ev.mul(ct, ct)),
               tag)
    log(f"{tag} card and CPU replay {time.perf_counter() - t0:.1f} s")

    # b. the block, cold
    TIMING.reset()
    reset_counters()
    keys0 = len(kg._rot_keys)
    with _BlockProbe(ev, enc, sync) as probe:
        out = LF.encrypted_attention(ev, enc, ct, w, seq, d, **ranges)
    launches = read_counters()
    marks = probe.marks
    res.update(block_s=marks["end"]["t"] - marks["start"]["t"],
               keys=len(kg._rot_keys) - keys0,
               keys_s=TIMING.seconds("RTM_ROT_KEY_REGEN"),
               rotations=probe.counts["rotate"],
               mul_plain=probe.counts["mul_plain"],
               encodes=probe.counts["encode"], level_in=ct.level,
               level_out=out.level, launches=launches, limbs=read_limbs())
    got = enc.decode(ev.decrypt(out)).real[:seq * d].reshape(seq, d)
    want = LF.attention_plain(x, w, seq, d)
    res["max_err"] = float(np.max(np.abs(got - want)))
    res["max_plain"] = float(np.max(np.abs(want)))
    res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if on_card else None)
    log(f"{tag} ranges certified from the plain shadow: " + ", ".join(
        f"{k} {v!r}" for k, v in ranges.items()))
    log(f"{tag} block cold {res['block_s']:.2f} s: {res['keys']} rotation "
        f"keys in {res['keys_s']:.2f} s; {res['rotations']} rotations, "
        f"{res['mul_plain']} mul_plain, {res['encodes']} encode_cached "
        f"misses; level {ct.level} -> {out.level} ({ct.level - out.level} "
        f"levels); launches {launches}; NTT limbs {res['limbs']}")
    for st, sec, nk, ks, nr, nm, ne in probe.stages():
        log(f"{tag}   {st:12s} {sec:8.2f} s: {nk:4d} keys {ks:7.2f} s, "
            f"{nr:5d} rotations, {nm:5d} mul_plain, {ne:5d} encodes")
    log(TIMING.report())
    log(f"{tag} max_err {res['max_err']:.4e} of max|plain| "
        f"{res['max_plain']:.4f} (limit {ATTN_TOL}); peak device memory "
        + (f"{res['peak_gib']:.2f} GiB" if on_card else "not measured (CPU)"))
    if not (np.all(np.isfinite(got)) and got.shape == (seq, d)):
        raise AssertionError("attention output is not finite")
    if not res["max_err"] < ATTN_TOL:
        raise AssertionError(f"attention max_err {res['max_err']} >= "
                             f"{ATTN_TOL}")

    # c. the q projection again, keys held, under the profiler; its
    # unprofiled time is the block's, per projection, keys excluded
    y, q = probe.first_projection
    proj = dict((st[0], st) for st in probe.stages())["projections"]
    res["projection_s"] = (proj[1] - proj[3]) / 3
    log(f"{tag} one projection at level {y.level}: {res['projection_s']:.2f}"
        f" s in the block, keys excluded ({2 * d - 2} rotations)")
    wq = np.asarray(w["wq"])
    p = profile_inference(lambda: LF._matmul_plain_w(ev, enc, y, wq, seq, d),
                          res["projection_s"], tag, dev)
    if not all(torch.equal(getattr(p, c).data, getattr(q, c).data)
               for c in ("c0", "c1")):
        raise AssertionError("the profiled projection differs from the "
                             "block's")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the digit x slot SPMD key switch on worlds of ranks
# ---------------------------------------------------------------------------

SPMD_SLOTS = 2   # 9a: Q_PARTS digits x 2 slots, six ranks sharing the card
SPMD_ROT = 1
SPMD_TOL = 1e-2  # the dry run's decode bound (__graft_entry__.py)
NCCL_LEVEL = 12  # 9c: one digit (34 q primes in 3 parts of 12)
MESH_CALLS = 3   # 9a-9d: each op and phase 4's model, through programs


def spmd_kw(degree: int = DEGREE) -> dict:
    """ResNet-20's ring and chain, as phases 3 and 5 use them."""
    return dict(degree=degree, num_q=NUM_Q, first_mod_size=60,
                scaling_mod_size=56, hamming_weight=192,
                num_q_parts=Q_PARTS)


def _untimed(name, f):
    return f()


def spmd_ops(c, ct, clock=_untimed) -> dict:
    """9a's ops on ct (at the top level) through c's evaluator (c: a
    context, or one with another evaluator): rotate by SPMD_ROT, mul
    (mul3, then relinearize), and the dry run's conv slice
    (scripts/torch_multichip.py's conv_slice). clock(name, f) runs each."""
    from ace_tpu_torch.utils.scripts import load_script
    ev = c.evaluator
    conv = load_script("torch_multichip").conv_slice
    return {"rotate": clock("rotate", lambda: ev.rotate(ct, SPMD_ROT)),
            "mul": clock("mul", lambda: ev.mul(ct, ct)),
            "conv": clock("conv", lambda: conv(c, ct))}


def spmd_expect(msg) -> dict:
    from ace_tpu_torch.utils.scripts import load_script
    return {"rotate": np.roll(msg, -SPMD_ROT), "mul": msg ** 2,
            "conv": load_script("torch_multichip").conv_plain(msg)}


def mesh_msgs(seed: int, degree: int) -> list:
    """MESH_CALLS messages of uniform(-1, 1) in N/2 slots: 9a's (and
    9c's), or one dp row's in 9d."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, degree // 2) for _ in range(MESH_CALLS)]


def _digest(ct, crt=None) -> str:
    """sha256 of ct's residues; with a limb-sharded CRT context `crt`,
    of every limb gathered in global order (a collective)."""
    import hashlib
    from ace_tpu_torch.ops import modops
    h = hashlib.sha256()
    for p in (ct.c0, ct.c1):
        data = p.data if crt is None else crt.gather_poly(p)
        h.update(modops.to_numpy(data).tobytes())
    return h.hexdigest()


def _rank_enter(mesh, t_spawn: float) -> dict:
    """Seconds after the parent's spawn at which this rank had imported
    torch and the port (`import_s`), joined the process group
    (`group_s`), made its mesh's groups (`entry_s`) and held a CUDA
    context (`context_s`)."""
    import torch
    tl = mesh.timeline
    res = {"import_s": tl["start"] - t_spawn,
           "group_s": tl["process_group"] - t_spawn,
           "entry_s": tl["mesh"] - t_spawn}
    if mesh.device.type == "cuda":
        torch.zeros(1, device=mesh.device)
        torch.cuda.synchronize(mesh.device)
    res["context_s"] = time.time() - t_spawn
    return res


def _rank_exit(mesh, res: dict) -> dict:
    """This rank's launches (since the last reset) and collectives, the
    launches and its launches through programs (`launches_programs`)
    summed over the world, and the rank's device memory (its own
    process's allocations and reservations: 0 on the CPU)."""
    import torch
    from ace_tpu_torch.ops import read_counters
    res["launches"] = read_counters()
    cuda = mesh.device.type == "cuda"
    for key, f in (("allocated_b", "memory_allocated"),
                   ("max_allocated_b", "max_memory_allocated"),
                   ("max_reserved_b", "max_memory_reserved")):
        res[key] = getattr(torch.cuda, f)(mesh.device) if cuda else 0
    res["mesh"] = mesh.stats()
    names = sorted(res["launches"])
    progs = res.get("launches_programs", {})
    total = mesh.sum_over_world([res["launches"][k] for k in names]
                                + [progs.get(k, 0) for k in names])
    res["launches_world"] = dict(zip(names, total[:len(names)]))
    res["launches_programs_world"] = dict(zip(names, total[len(names):]))
    return res


def _add_launches(acc: dict, delta: dict) -> None:
    for (k, attr), v in delta.items():
        if attr == "launches":
            acc[k] = acc.get(k, 0) + v


def _clock(sync, times: dict, deltas: dict):
    """clock(name, f) for spmd_ops and limb_ops: f() between two
    synchronizations, its seconds into times[name] and its
    kernel-counter growth into deltas[name]."""
    from ace_tpu_torch.ops import counter_delta, counter_state

    def clock(name, f):
        sync()
        before = counter_state()
        t0 = time.perf_counter()
        out = f()
        sync()
        times[name] = time.perf_counter() - t0
        deltas[name] = counter_delta(before)
        return out
    return clock


def mesh_op_calls(ctx, eager, run_ops, msgs, sync, crt=None) -> dict:
    """run_ops (spmd_ops or limb_ops) through ctx's evaluator, programs
    on, on each message of msgs encrypted in turn (its programs' calls
    1, 2 and 3), then on the last ciphertext again through `eager` (ctx
    with an evaluator of programs=False): each call's digests (`crt`: a
    limb-sharded context, whose digests gather) and op seconds; the
    eager call's too. Raises when the eager call's digests or any op's
    kernel-counter growth differ from the third call's. Also returns the
    launches of the calls through programs."""
    calls, launches = [], {}
    for msg in msgs:
        ct = ctx.prepare_input(msg, "x")
        times, deltas = {}, {}
        outs = run_ops(ctx, ct, _clock(sync, times, deltas))
        for d in deltas.values():
            _add_launches(launches, d)
        calls.append({"digests": {k: _digest(v, crt)
                                  for k, v in outs.items()},
                      "s": times, "deltas": deltas})
    times, deltas = {}, {}
    outs = run_ops(eager, ct, _clock(sync, times, deltas))
    eager_call = {"digests": {k: _digest(v, crt) for k, v in outs.items()},
                  "s": times}
    if eager_call["digests"] != calls[-1]["digests"]:
        raise AssertionError("the third call through programs differs from "
                             "the eager evaluator's on the same input")
    bad = [k for k in deltas if deltas[k] != calls[-1]["deltas"][k]]
    if bad:
        raise AssertionError(f"ops {bad}: a replay's kernel-counter growth "
                             f"differs from the eager call's")
    for c in calls:
        del c["deltas"]
    return {"calls": calls, "eager": eager_call, "launches": launches}


def mesh_model_runs(model, ctx, img, want, sync, crt=None) -> dict:
    """Phase 4's model MESH_CALLS times through ctx's programs:
    infer_encrypted, then the runner again on that run's input
    ciphertext. Each run's seconds, whether its output residues (gathered
    under a limb-sharded `crt`) equal `want` (phase 4's), its output
    level, and the runs' launches."""
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.ops import counter_delta, counter_state, modops
    runs, launches = [], {}
    ct_in = None
    for k in range(MESH_CALLS):
        before = counter_state()
        t0 = time.perf_counter()
        if ct_in is None:
            M.infer_encrypted(model, img)
            ct_in = ctx.get_input_data("input")
            out = ctx.get_output_data("output")
        else:
            out = model.runner.run(ct_in)
        sync()
        secs = time.perf_counter() - t0
        _add_launches(launches, counter_delta(before))
        equal = all(
            np.array_equal(modops.to_numpy(
                p.data if crt is None else crt.gather_poly(p)), w)
            for p, w in zip((out.c0, out.c1), want))
        runs.append({"s": secs, "equal": equal, "level": out.level})
    return {"runs": runs, "launches": launches}


def _programs_report(ev) -> dict:
    """The rank's op programs: pool counts, segments per kind (program
    key's first item; SpmdKeySwitch's as "spmd rot" / "spmd relin")."""
    segs = ev.program_segments()
    return {"stats": ev.program_stats(),
            "segments": {k: sorted(set(v)) for k, v in segs.items()},
            "programs_by_kind": {k: len(v) for k, v in segs.items()}}


def rank_spmd_ops(mesh, kw, seed, msgs, t_spawn):
    """9a on one rank: spmd_ops through FheContext(digit_mesh=mesh) with
    programs on, on each of msgs (mesh_op_calls), the third against an
    SpmdEvaluator with programs off on the same keys."""
    import types
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.ops import reset_counters
    from ace_tpu_torch.parallel.spmd_eval import SpmdEvaluator
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import syncer
    res = _rank_enter(mesh, t_spawn)
    sync = syncer(mesh.device)
    t0 = time.perf_counter()
    ctx = FheContext(CkksParams(**kw, device=mesh.device), seed=seed,
                     digit_mesh=mesh)
    sync()
    res["setup_s"] = time.perf_counter() - t0
    ev = ctx.evaluator
    eager = types.SimpleNamespace(
        evaluator=SpmdEvaluator(ctx.params, ctx.keygen, ctx.encoder, mesh,
                                programs=False),
        encoder=ctx.encoder, params=ctx.params)
    reset_counters()
    mesh.reset_stats()
    t0 = time.perf_counter()
    calls = mesh_op_calls(ctx, eager, spmd_ops, msgs, sync)
    res["ops_s"] = time.perf_counter() - t0
    res["calls"], res["eager"] = calls["calls"], calls["eager"]
    res["launches_programs"] = calls["launches"]
    res["switches"] = ev.spmd_switches
    res["resident"] = {lv: k.key_memory_resident_bytes()
                       for lv, k in ev._spmd.items() if k is not None}
    res["full_keys_b"] = sum(k.nbytes for k in ctx.keygen.all_keys())
    res["report"] = ev.key_residency_report()
    res["programs"] = _programs_report(ev)
    return _rank_exit(mesh, res)


def rank_spmd_model(mesh, sm, want, t_spawn):
    """9b on one rank: phase 4's model through compile_model and
    FheContext(digit_mesh=mesh), programs on, MESH_CALLS times
    (mesh_model_runs); its output residues against phase 4's (`want`)."""
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.ops import reset_counters
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import syncer
    res = _rank_enter(mesh, t_spawn)
    sync = syncer(mesh.device)
    t0 = time.perf_counter()
    ctx = FheContext(scheme_info=sm["info"], max_rot_keys=100,
                     device=mesh.device, digit_mesh=mesh)
    model = M.compile_model(sm["graph"], sm["cfg"], ctx=ctx,
                            num_classes=sm["out_len"])
    sync()
    res["setup_s"] = time.perf_counter() - t0
    reset_counters()
    mesh.reset_stats()
    t0 = time.perf_counter()
    runs = mesh_model_runs(model, ctx, sm["img"], want, sync)
    res["inference_s"] = time.perf_counter() - t0
    res["runs"] = runs["runs"]
    res["launches_programs"] = runs["launches"]
    res["switches"] = ctx.evaluator.spmd_switches
    res["report"] = ctx.evaluator.key_residency_report()
    res["programs"] = _programs_report(ctx.evaluator)
    return _rank_exit(mesh, res)


def rank_one(mesh, kw, seed, msgs, level, t_spawn):
    """9c on a one-rank world: SpmdKeySwitch.rotate at `level` through
    its program on each of msgs (calls 1-3: eager, captured, replayed)."""
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.ops import reset_counters
    from ace_tpu_torch.parallel.spmd import SpmdKeySwitch
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import syncer
    res = _rank_enter(mesh, t_spawn)
    ctx = FheContext(CkksParams(**kw, device=mesh.device), seed=seed)
    ksw = SpmdKeySwitch(ctx.params, level, mesh)
    reset_counters()
    mesh.reset_stats()
    res["digests"] = []
    for msg in msgs:
        ct = ctx.prepare_input(msg, "x", level=level)
        res["digests"].append(_digest(ksw.rotate(ct, SPMD_ROT, ctx.keygen)))
    syncer(mesh.device)()
    res["switches"] = ksw.switches
    res["segments"] = ksw._jit_cache["rot"].segments
    res["stats"] = ksw.pool.stats()
    return _rank_exit(mesh, res)


def _rank_line(tag: str, r: int, res: dict, *keys) -> None:
    m = res["mesh"]
    log(f"{tag} rank {r}: imported {res['import_s']:.1f} s, process group "
        f"{res['group_s']:.1f} s, mesh {res['entry_s']:.1f} s, CUDA context "
        f"{res['context_s']:.1f} s after spawn; "
        + "".join(f"{k} {res[k]:.2f} s; " for k in keys)
        + f"{res['switches']} SPMD key switches; {m['collectives']} "
        f"collectives {m['collective_s']:.2f} s, staged {m['staged_bytes']}"
        f" B in {m['staged_s']:.2f} s; device memory allocated "
        f"{res['allocated_b']} B, peak {res['max_allocated_b']} B, peak "
        f"reserved {res['max_reserved_b']} B; launches {res['launches']}")


def _programs_line(tag: str, r: int, res: dict) -> None:
    p = res["programs"]
    st = p["stats"]
    log(f"{tag} rank {r} programs: {st['cached']} cached of "
        f"{st['programs']} lifted, by kind {p['programs_by_kind']}, "
        f"segments by kind {p['segments']}; {st['captures']} captured "
        f"({st['segments']} graph segments) in {st['capture_s']:.2f} s; "
        f"{st['replays']} replays; staging {st['staging_bytes']} B, graph "
        f"pool {st['pool_bytes']} B")


def _calls_line(tag: str, r: int, res: dict) -> None:
    """Each op's seconds at each call through programs and eagerly."""
    ops_ = list(res["eager"]["s"])
    log(f"{tag} rank {r} op seconds, calls 1 / 2 / 3 through programs -> "
        f"eager on call 3's input: " + "; ".join(
            f"{k} " + " / ".join(f"{c['s'][k]:.4f}" for c in res["calls"])
            + f" -> {res['eager']['s'][k]:.4f}" for k in ops_))


def _check_calls(tag: str, ranks: list, want: list, rows=None) -> None:
    """Every call of every rank (of dp row `rows(r)`) equal to the
    single-device digests `want[row][call]`."""
    for r, res in enumerate(ranks):
        ref = want[rows(r) if rows else 0]
        bad = [k for k, c in enumerate(res["calls"]) if c["digests"]
               != ref[k]]
        if bad:
            raise AssertionError(f"{tag} rank {r}: calls {[k + 1 for k in bad]}"
                                 f" through programs differ from the "
                                 f"single-device Evaluator")


def _check_runs(tag: str, ranks: list) -> None:
    bad = {r: [k + 1 for k, x in enumerate(res["runs"]) if not x["equal"]]
           for r, res in enumerate(ranks)}
    if any(bad.values()):
        raise AssertionError(f"{tag} runs whose output residues differ from "
                             f"phase 4's, by rank: {bad}")


def _runs_text(ranks: list) -> str:
    return "; ".join(f"rank {r} " + " / ".join(f"{x['s']:.2f}"
                                               for x in res["runs"])
                     for r, res in enumerate(ranks))


def mesh_summary(op_ranks: list, model_ranks: list) -> str:
    """Rank 0's op seconds at call 3 through programs against eager, its
    model runs' seconds, and each rank's graph pool and peak reserved
    memory."""
    r0 = op_ranks[0]
    ops_ = ", ".join(f"{k} {r0['eager']['s'][k]:.4f} -> "
                     f"{r0['calls'][-1]['s'][k]:.4f}"
                     for k in r0["eager"]["s"])
    runs = " / ".join(f"{x['s']:.2f}" for x in model_ranks[0]["runs"])
    mem = "; ".join(
        f"rank {r} pool {res['programs']['stats']['pool_bytes']} B, peak "
        f"reserved {res['max_reserved_b']} B"
        for r, res in enumerate(model_ranks))
    return (f"rank 0 op s eager -> replayed (call 3) {ops_}; model runs "
            f"{runs} s; {mem}")


def phase_spmd(device=None, kw: dict | None = None, sm: dict | None = None,
               want=None) -> dict:
    """The digit x slot SPMD key switch (ace_tpu_torch/parallel) on three
    worlds of spawned ranks, every rank on the same card (gloo stages
    the collectives through the host; NCCL refuses two ranks on one
    device), with op programs on (split at the collectives,
    utils/liftgraph.py):
      a. a Q_PARTS x SPMD_SLOTS gloo world: spmd_ops at the top level on
         MESH_CALLS messages (calls 1, 2, 3 of the programs: eager,
         captured, replayed), every call on every rank bit-identical to
         the single-device Evaluator under the same seeded keys, decoding
         within SPMD_TOL of the plain values; the third call timed op by
         op against an SpmdEvaluator with programs off on the same input,
         equal to it with equal kernel-counter growth; each rank stacks
         1/(D*s) of every key it used (its KeyGenerator still holds the
         full keys: the rank lines give its device memory);
      b. a Q_PARTS x 1 gloo world: `sm` (phase 4's model) through
         compile_model with FheContext(digit_mesh=), MESH_CALLS runs, each
         output's residues equal to `want` (phase 4's), with at least one
         SPMD key switch on every rank;
      c. a one-rank world on NCCL (gloo on the CPU, where NCCL does not
         run): SpmdKeySwitch.rotate at level NCCL_LEVEL (one digit)
         through its program, MESH_CALLS times, each equal to the
         single-device rotate; between the replays the steps run NCCL.
    Every rank must launch K1 in a and b. Returns the kernels' launches
    in a and b summed over the ranks, those through programs there, and
    the seconds of each part. device=None is the card; "cpu" rehearses
    every part on gloo."""
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import syncer

    dev = resolve_device(device)
    kw = kw or spmd_kw()
    digits, slots = kw["num_q_parts"], SPMD_SLOTS
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        mode = smi.stdout.strip()
        log(f"[phase 9] compute mode: {mode}")
        if "Exclusive" in mode:
            raise RuntimeError(f"compute mode {mode}: the ranks cannot "
                               f"share the card")
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.empty_cache()
    sync = syncer(dev)
    msgs = mesh_msgs(SEED + 9, kw["degree"])
    secs = {}

    def world(fn, d, s, backend, *args):
        t0 = time.perf_counter()
        with file_rendezvous(kernels.build_dir()) as rdv:
            out = run_world(fn, d, s, backend, str(dev), rdv,
                            args + (time.time(),))
        return out, time.perf_counter() - t0

    def k1_everywhere(tag, ranks):
        if not all(r["launches"]["K1"] > 0 for r in ranks) \
                and dev.type == "cuda":
            raise AssertionError(f"{tag} K1 did not launch on every rank: "
                                 f"{[r['launches'] for r in ranks]}")

    # a. key switches on a digits x slots world
    ranks, secs["9a"] = world(rank_spmd_ops, digits, slots, "gloo", kw,
                              SEED, msgs)
    tag = "[phase 9a]"
    for r, res in enumerate(ranks):
        _rank_line(tag, r, res, "setup_s", "ops_s")
        _programs_line(tag, r, res)
        _calls_line(tag, r, res)
    t0 = time.perf_counter()
    params = CkksParams(**kw, device=dev)
    ctx = FheContext(params, seed=SEED)
    want_a, first = [], None
    for msg in msgs:
        ref = spmd_ops(ctx, ctx.prepare_input(msg, "x"))
        want_a.append({k: _digest(v) for k, v in ref.items()})
        first = first or ref
    sync()
    secs["9a_single"] = time.perf_counter() - t0
    _check_calls(tag, ranks, [want_a])
    errs, plain = {}, spmd_expect(msgs[0])
    for k, v in first.items():
        ctx.set_output_data(k, v)
        errs[k] = float(np.max(np.abs(ctx.handle_output(k, 64)
                                      - plain[k][:64])))
    log(f"{tag} {len(ranks)} ranks ({digits} x {slots}) bit-identical to "
        f"the single-device Evaluator ({secs['9a_single']:.2f} s alone) "
        f"at each of {MESH_CALLS} calls through programs for rotate, mul "
        f"and the conv slice, the third also equal to the eager "
        f"SpmdEvaluator's with equal kernel counts; max decode errors "
        f"{errs} (limit {SPMD_TOL}); world {secs['9a']:.1f} s")
    if not max(errs.values()) <= SPMD_TOL:
        raise AssertionError(f"{tag} decode errors {errs}")
    key_b = ctx.keygen.relin_key.nbytes
    top = kw["num_q"]
    for r, res in enumerate(ranks):
        per = res["resident"]
        # rotations SPMD_ROT and 8 and the relinearization key at the top
        if per[top] * digits * slots != 3 * key_b:
            raise AssertionError(f"{tag} rank {r} holds {per[top]} B of "
                                 f"keys at level {top}, not 3 x {key_b} / "
                                 f"{digits * slots}")
    log(f"{tag} key stack bytes by level, rank 0: {ranks[0]['resident']}"
        f" (at level {top}: 3 keys of {key_b} B, each 1/{digits * slots} "
        f"per rank = {key_b // (digits * slots)} B); {ranks[0]['report']}; "
        f"the rank's KeyGenerator also holds the full keys, "
        f"{ranks[0]['full_keys_b']} B (device memory: the rank lines)")
    if any(res["switches"] <= 0 for res in ranks):
        raise AssertionError(f"{tag} a rank took no SPMD key switch")
    k1_everywhere(tag, ranks)
    launches = dict(ranks[0]["launches_world"])
    via = dict(ranks[0]["launches_programs_world"])
    times = {"9a": ranks}
    del ctx, ref, first

    # b. the model path on a digits x 1 world
    tag = "[phase 9b]"
    ranks_b, secs["9b"] = world(rank_spmd_model, digits, 1, "gloo", sm,
                                want)
    for r, res in enumerate(ranks_b):
        _rank_line(tag, r, res, "setup_s", "inference_s")
        _programs_line(tag, r, res)
    _check_runs(tag, ranks_b)
    if any(res["switches"] <= 0 for res in ranks_b):
        raise AssertionError(f"{tag} no SPMD key switch was taken: "
                             f"{[res['switches'] for res in ranks_b]}")
    k1_everywhere(tag, ranks_b)
    for k, v in ranks_b[0]["launches_world"].items():
        launches[k] += v
        via[k] += ranks_b[0]["launches_programs_world"][k]
    times["9b"] = ranks_b
    log(f"{tag} {len(ranks_b)} ranks: each of {MESH_CALLS} runs' output "
        f"(level {ranks_b[0]['runs'][0]['level']}) equal to phase 4's "
        f"residue for residue, {ranks_b[0]['switches']} SPMD key switches "
        f"a rank; run seconds {_runs_text(ranks_b)}; {ranks_b[0]['report']};"
        f" world {secs['9b']:.1f} s")

    # c. a one-rank world on NCCL
    backend = "nccl" if dev.type == "cuda" else "gloo"
    tag = f"[phase 9c {backend}]"
    ranks_c, secs["9c"] = world(rank_one, 1, 1, backend, kw, SEED, msgs,
                                NCCL_LEVEL)
    _rank_line(tag, 0, ranks_c[0])
    ctx = FheContext(params, seed=SEED)
    want_c = [_digest(ctx.evaluator.rotate(
        ctx.prepare_input(msg, "x", level=NCCL_LEVEL), SPMD_ROT))
        for msg in msgs]
    if ranks_c[0]["digests"] != want_c:
        raise AssertionError(f"{tag} SpmdKeySwitch.rotate differs from the "
                             f"single-device rotate")
    st = ranks_c[0]["stats"]
    log(f"{tag} rotate at level {NCCL_LEVEL} ({params.crt.num_decomp(NCCL_LEVEL)}"
        f" digit) through its program, {MESH_CALLS} calls, each "
        f"bit-identical to the single-device rotate; "
        f"{ranks_c[0]['segments']} segments, {st['captures']} captured in "
        f"{st['capture_s']:.2f} s, {st['replays']} replays, graph pool "
        f"{st['pool_bytes']} B; world {secs['9c']:.1f} s")
    return {"launches_spmd": launches, "launches_programs": via,
            "seconds": secs, "ranks": times}


# ---------------------------------------------------------------------------
# Phase 9d: the limb-sharded evaluator on a dp x limb world
# ---------------------------------------------------------------------------

LIMB_DP, LIMB_N = 2, 2     # 9d: 2 x 2 ranks sharing the card
LIMB_ROT = 3
LIMB_MAC_ROTS = (1, 2, 5)


def limb_msgs(kw: dict, dp: int) -> list:
    """9d's messages of dp row `dp` (each row runs its own)."""
    return mesh_msgs(SEED + 90 + dp, kw["degree"])


def limb_ops(c, ct, clock=_untimed) -> dict:
    """9d (i) on ct (at the top level) through c's evaluator: mul +
    relinearize, rotate by LIMB_ROT, rescale of the product, and
    FheBackend.rot_ext_mac_groups over LIMB_MAC_ROTS (the conv path's
    bundle). clock(name, f) runs each."""
    from ace_tpu_torch.compiler.packing import FheBackend
    ev = c.evaluator
    m = clock("mul", lambda: ev.mul(ct, ct))
    w = np.ones(c.params.degree // 2)
    be = FheBackend(ev, c.encoder)
    return {"rotate": clock("rotate", lambda: ev.rotate(ct, LIMB_ROT)),
            "mul": m, "rescale": clock("rescale", lambda: ev.rescale(m)),
            "mac": clock("mac", lambda: be.rot_ext_mac_groups(
                ct, list(LIMB_MAC_ROTS), [[w, w, None]])[0])}


def limb_expect(msg) -> dict:
    return {"rotate": np.roll(msg, -LIMB_ROT), "mul": msg ** 2,
            "rescale": msg ** 2, "mac": np.roll(msg, -1) + np.roll(msg, -2)}


def rank_limb(mesh, kw, sm, want, t_spawn):
    """9d on one rank: (i) limb_ops on its dp row's messages through
    FheContext(mesh=mesh), programs on (mesh_op_calls, the third call
    against an Evaluator with programs off), (ii) phase 4's model through
    compile_model with FheContext(mesh=mesh), MESH_CALLS runs; the
    gathered residues' digests (i) and equality with phase 4's (ii)."""
    import types
    from ace_tpu_torch.ckks.evaluator import Evaluator
    from ace_tpu_torch.ckks.keygen import switch_key_nbytes
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.ops import reset_counters
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import syncer
    res = _rank_enter(mesh, t_spawn)
    sync = syncer(mesh.device)
    t0 = time.perf_counter()
    ctx = FheContext(CkksParams(**kw, device=mesh.device), seed=SEED,
                     mesh=mesh)
    sync()
    res["setup_s"] = time.perf_counter() - t0
    crt = ctx.params.crt
    res["rows"] = crt.local(range(crt.num_q + crt.num_p))
    res["key_b"] = ctx.keygen.relin_key.nbytes
    res["key_total_b"] = switch_key_nbytes(ctx.params)
    eager = types.SimpleNamespace(
        evaluator=Evaluator(ctx.params, ctx.keygen, ctx.encoder,
                            programs=False),
        encoder=ctx.encoder, params=ctx.params)
    reset_counters()
    mesh.reset_stats()
    t0 = time.perf_counter()
    calls = mesh_op_calls(ctx, eager, limb_ops, limb_msgs(kw, mesh.dp),
                          sync, crt)
    res["ops_s"] = time.perf_counter() - t0
    res["ops_mesh"] = mesh.stats()
    res["calls"], res["eager"] = calls["calls"], calls["eager"]
    res["keys_b"] = ctx.key_memory_bytes()  # relin + the four rotations
    res["ops_programs"] = _programs_report(ctx.evaluator)
    del ctx, eager
    t0 = time.perf_counter()
    mctx = FheContext(scheme_info=sm["info"], max_rot_keys=100,
                      device=mesh.device, mesh=mesh)
    model = M.compile_model(sm["graph"], sm["cfg"], ctx=mctx,
                            num_classes=sm["out_len"])
    sync()
    res["model_setup_s"] = time.perf_counter() - t0
    mesh.reset_stats()
    t0 = time.perf_counter()
    runs = mesh_model_runs(model, mctx, sm["img"], want, sync,
                           mctx.params.crt)
    res["inference_s"] = time.perf_counter() - t0
    res["runs"] = runs["runs"]
    res["launches_programs"] = dict(calls["launches"])
    for k, v in runs["launches"].items():
        res["launches_programs"][k] = res["launches_programs"].get(k, 0) + v
    res["model_keys_b"] = mctx.key_memory_bytes()
    res["programs"] = _programs_report(mctx.evaluator)
    return _rank_exit(mesh, res)


def phase_limb(device=None, kw: dict | None = None, sm: dict | None = None,
               want=None) -> dict:
    """The limb-sharded evaluator (FheContext(mesh=...), CrtContext.shard)
    with op programs on (split at the gathers and broadcasts,
    utils/liftgraph.py) on a LIMB_DP x LIMB_N gloo world whose ranks share
    the card (gloo stages each gather and broadcast through the host):
      i. each dp row runs limb_ops on its own MESH_CALLS messages at
         ResNet-20's ring and chain (calls 1, 2, 3 of the programs); every
         rank's gathered residues at every call must equal the
         single-device Evaluator's on that message under the same seeded
         keys, which decode within SPMD_TOL; the third call is timed op
         by op against an Evaluator with programs off on the same input,
         equal to it with equal kernel-counter growth;
      ii. each dp row runs `sm` (phase 4's model) through compile_model,
         MESH_CALLS runs; every run's gathered output residues must equal
         `want` (phase 4's);
      iii. on the card, every rank must launch K1, K2, K3 and K4.
    Each rank holds its own limbs only (limb g on limb rank g mod
    LIMB_N), so its bytes of each key are its rows' share of
    switch_key_nbytes. Returns the launches of i-ii summed over the
    ranks, those through programs, the smallest per rank, and the
    seconds. device=None is the card; "cpu" rehearses it on gloo."""
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.parallel.mesh import (DP_LIMB, file_rendezvous,
                                             run_world)
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import syncer

    dev = resolve_device(device)
    kw = kw or spmd_kw()
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.empty_cache()
    sync = syncer(dev)
    tag = "[phase 9d]"
    secs = {}
    t0 = time.perf_counter()
    with file_rendezvous(kernels.build_dir()) as rdv:
        ranks = run_world(rank_limb, LIMB_DP, LIMB_N, "gloo", str(dev), rdv,
                          (kw, sm, want, time.time()), axes=DP_LIMB)
    secs["9d"] = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        m, mo = res["mesh"], res["ops_mesh"]
        rows = res["rows"]
        log(f"{tag} rank {r} (dp {r // LIMB_N}, limb {r % LIMB_N}): "
            f"imported {res['import_s']:.1f} s, process group "
            f"{res['group_s']:.1f} s, CUDA context {res['context_s']:.1f} s "
            f"after spawn; owns {len(rows)} of {kw['num_q']} + P limbs "
            f"({rows[0]}, {rows[1]}, ..., {rows[-1]}); relinearization key "
            f"{res['key_b']} B of switch_key_nbytes {res['key_total_b']} B;"
            f" keys of i {res['keys_b']} B, of ii {res['model_keys_b']} B; "
            f"setup {res['setup_s']:.2f} s, ops {res['ops_s']:.2f} s "
            f"({mo['collectives']} collectives {mo['collective_s']:.2f} s, "
            f"staged {mo['staged_bytes']} B in {mo['staged_s']:.2f} s); "
            f"model setup {res['model_setup_s']:.2f} s, {MESH_CALLS} runs "
            f"{res['inference_s']:.2f} s ({m['collectives']} collectives "
            f"{m['collective_s']:.2f} s, staged {m['staged_bytes']} B in "
            f"{m['staged_s']:.2f} s), run seconds "
            + " / ".join(f"{x['s']:.2f}" for x in res["runs"])
            + f"; device memory allocated {res['allocated_b']} B, peak "
            f"{res['max_allocated_b']} B, peak reserved "
            f"{res['max_reserved_b']} B; launches {res['launches']}")
        _programs_line(f"{tag} i:", r, dict(res, programs=res["ops_programs"]))
        _programs_line(f"{tag} ii:", r, res)
        _calls_line(tag, r, res)
    # i. against the single-device evaluator, one context per dp row
    t0 = time.perf_counter()
    errs, want_i = {}, []
    for dp in range(LIMB_DP):
        ctx = FheContext(CkksParams(**kw, device=dev), seed=SEED)
        msgs = limb_msgs(kw, dp)
        row = []
        for k, msg in enumerate(msgs):
            ref = limb_ops(ctx, ctx.prepare_input(msg, "x"))
            row.append({k: _digest(v) for k, v in ref.items()})
            if k == 0:
                plain = limb_expect(msg)
                for op, v in ref.items():
                    ctx.set_output_data(op, v)
                    errs[f"{op}{dp}"] = float(np.max(np.abs(
                        ctx.handle_output(op, 64) - plain[op][:64])))
        sync()
        want_i.append(row)
        del ctx, ref
    secs["9d_single"] = time.perf_counter() - t0
    _check_calls(tag, ranks, want_i, lambda r: r // LIMB_N)
    if not max(errs.values()) <= SPMD_TOL:
        raise AssertionError(f"{tag} decode errors {errs}")
    if ranks[0]["calls"][0]["digests"] == ranks[LIMB_N]["calls"][0][
            "digests"]:
        raise AssertionError(f"{tag} the dp rows' outputs agree: the rows "
                             f"did not run their own messages")
    log(f"{tag} i: {len(ranks)} ranks ({LIMB_DP} x {LIMB_N}), each dp row "
        f"bit-identical to the single-device Evaluator on its messages at "
        f"each of {MESH_CALLS} calls through programs "
        f"({secs['9d_single']:.2f} s for both alone) for rotate, mul, "
        f"rescale and rot_ext_mac_groups{list(LIMB_MAC_ROTS)}, the third "
        f"also equal to the eager Evaluator's with equal kernel counts; "
        f"max decode errors {errs} (limit {SPMD_TOL})")
    # each rank holds its rows' share of the key, the limb ranks all of it
    lk = sum(len(res["rows"]) for res in ranks[:LIMB_N])
    for r, res in enumerate(ranks):
        if res["key_b"] * lk != res["key_total_b"] * len(res["rows"]):
            raise AssertionError(f"{tag} rank {r} holds {res['key_b']} B of "
                                 f"a key, not {len(res['rows'])}/{lk} of "
                                 f"{res['key_total_b']}")
    if sum(res["key_b"] for res in ranks[:LIMB_N]) != ranks[0]["key_total_b"]:
        raise AssertionError(f"{tag} the limb ranks' key bytes do not add "
                             f"up to switch_key_nbytes")
    # ii.
    _check_runs(tag, ranks)
    log(f"{tag} ii: every rank's gathered output (level "
        f"{ranks[0]['runs'][0]['level']}) equal to phase 4's residue for "
        f"residue in each of {MESH_CALLS} runs; world {secs['9d']:.1f} s")
    # iii.
    if dev.type == "cuda":
        idle = {r: [k for k, v in res["launches"].items() if v == 0]
                for r, res in enumerate(ranks)}
        if any(idle.values()):
            raise AssertionError(f"{tag} kernels not launched on every "
                                 f"rank: {idle}")
    names = sorted(ranks[0]["launches"])
    return {"launches_limb": dict(ranks[0]["launches_world"]),
            "launches_programs": dict(ranks[0]["launches_programs_world"]),
            "launches_min": {k: min(res["launches"][k] for res in ranks)
                             for k in names},
            "seconds": secs, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 10: the benchmark entry points at N = 2^16
# ---------------------------------------------------------------------------

BENCH_ITERS = 5       # bench_micro_torch's --iters in phase 10
BENCH_TOL = 1e-4      # decode bound of the rotate and the mul+relin+rescale
BTS_TOL = 2e-2        # phase 5's bootstrap bound
BENCH_SPARSE = 1 << 12


def phase_bench(device=None, degree: int = 1 << 16, num_q: int = 24,
                iters: int = BENCH_ITERS, sparse: int = BENCH_SPARSE) -> dict:
    """bench_torch.py and bench_micro_torch.py at their defaults, through
    their own functions (the scripts loaded from the checkout):
    (a) the native C library's build and the one-thread CPU NTT baseline;
    (b) through kernel_row (equal word for word to the plain versions;
        timed on the card): K3 and K4 at bench_torch's [8, N], round
        trip included (ntt_rows), then K1-K4 over bench_micro_torch's
        whole chain [num_q + P, N] and over its q primes alone
        (chain_rows), the shapes of the key switch and the ops;
    (c) bench_torch's chained K3 passes at [8, N]: NTT/s, vs_baseline;
    (d) bench_micro_torch's context and ops (--iters `iters`), then one
        rotate and one mul+relin+rescale decoded against np.roll(msg, -1)
        and msg * msg within BENCH_TOL;
    (e) the full bootstrap (N/2 slots, msg * 0.1 at level 2) cold and
        warm, and the sparse one at `sparse` slots cold, each decoded
        within BTS_TOL.
    The kernel counters are set to 0 after (b) and read after (e): the
    launches of (c)-(e). The moduli are bench_micro_torch's defaults;
    device, degree, num_q, iters and sparse let the CPU run it small."""
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.ops import modops, native, read_counters, \
        reset_counters
    from ace_tpu_torch.runtime.timing import TIMING
    from ace_tpu_torch.utils.card import syncer
    import bench_micro_torch as bm
    import bench_torch as bt

    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    sync = syncer(dev)
    if gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {}

    t0 = time.perf_counter()
    built = native.build()
    out["native_build_s"] = time.perf_counter() - t0
    cpu = bt.bench_cpu_baseline(degree)
    log(f"[phase 10] (a) native library {'built' if built else 'cached'} "
        f"in {out['native_build_s']:.2f} s; one-thread C NTT at N = "
        f"{degree}: {cpu['ms']:.4f} ms = {cpu['ntt_per_s']:.1f} NTT/s")

    t0 = time.perf_counter()
    defaults = bm.parse_args([])
    ctx = bm.make_context(degree, num_q, defaults.first_mod_size,
                          defaults.scaling_mod_size, dev)
    sync()
    out["context_s"] = time.perf_counter() - t0
    crt = ctx.params.crt
    log(f"[phase 10] (d) bench_micro_torch context: N = {degree}, "
        f"{crt.num_q} q + {crt.num_p} P primes, {ctx.params.num_q_parts} "
        f"digits, in {out['context_s']:.2f} s")

    _, t8, x8 = bt.ntt_inputs(degree, bt.LIMBS, dev)
    rng_b = np.random.default_rng(SEED)
    tag = "[phase 10] (b)"
    out["kernel_rows"] = ntt_rows(t8, [x8] + residue_sets(
        modops.to_numpy(t8.q)[:, 0], degree, dev, rng_b, 3),
        "bench_torch's shape", tag)
    for limbs, what in ((range(crt.num_q + crt.num_p),
                         "bench_micro_torch's q and P chain"),
                        (range(crt.num_q), "bench_micro_torch's q chain")):
        out["kernel_rows"] += chain_rows(crt, limbs, what, tag, rng_b)

    reset_counters()
    d = bt.bench_device(degree, bt.LIMBS, dev)
    line = bt.ntt_metric(d["ntt_per_s"], cpu["ntt_per_s"])
    out["bench_ntt"] = dict(line, pass_event_ms=d["pass_event_ms"],
                            rates=d["rates"])
    b_ms, _ = bound(4 * bt.LIMBS * degree * 8, SHOUP_IMAD * bt.LIMBS
                    * (degree // 2) * (degree.bit_length() - 1))
    ev = (f"; one pass between CUDA events {d['pass_event_ms']:.4f} ms "
          f"({d['pass_event_ms'] / bt.STEADY_ITERS * 1e3:.2f} us a call); "
          f"{ntt_shape(bt.LIMBS, degree)}" if gpu else "")
    log(f"[phase 10] (c) bench_torch --ntt: {json.dumps(line)}; passes "
        f"{[round(r, 1) for r in d['rates']]} NTT/s; bound {b_ms * 1e3:.2f} "
        f"us a call = {bt.LIMBS / b_ms * 1e3:.4g} NTT/s{ev}")

    rng = np.random.default_rng(0)  # bench_micro_torch's: msg, then
    o = bm.operands(ctx, rng)         # the sparse bootstrap's input
    ops = {}
    for name, fn, leaf in bm.op_table(ctx, o):
        ops[name] = bm.timed(fn, leaf, iters, sync)
    out["ops_ms"] = {k: v * 1e3 for k, v in ops.items()}
    log("[phase 10] (d) ops (ms, --iters " + str(iters) + "): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["ops_ms"].items()))
    ev_, msg = ctx.evaluator, o["msg"].real
    checks = (("rotate", ev_.rotate(o["ct1"], 1), np.roll(msg, -1)),
              ("mul+relin+rescale",
               ev_.rescale(ev_.mul(o["ct1"], o["ct2"])), msg * msg))
    for what, ct, want in checks:
        ctx.set_output_data(what, ct)
        e = float(np.max(np.abs(ctx.handle_output(what) - want)))
        out[f"err_{what}"] = e
        log(f"[phase 10] (d) {what} decodes within {e:.3e} (limit "
            f"{BENCH_TOL})")
        if not e <= BENCH_TOL:
            raise AssertionError(f"{what} at N = {degree} decodes with "
                                 f"error {e}")

    TIMING.enabled = True
    bts = {}
    for name, fn, _, want in bm.bootstrap_cases(ctx, o, rng, True, sparse):
        runs = ("cold", "warm") if name == "bootstrap_full" else ("cold",)
        for run in runs:
            TIMING.reset()
            t0 = time.perf_counter()
            ct = fn()
            sync()
            secs = time.perf_counter() - t0
            ctx.set_output_data(name, ct)
            e = float(np.max(np.abs(ctx.handle_output(name) - want.real)))
            bts[f"{name}_{run}"] = secs
            out[f"err_{name}_{run}"] = e
            log(f"[phase 10] (e) {name} {run} {secs:.2f} s (tables "
                f"{TIMING.seconds('RTM_BS_SETUP'):.2f} s, "
                f"{TIMING.count('RTM_ROT_KEY_REGEN')} rotation keys "
                f"{TIMING.seconds('RTM_ROT_KEY_REGEN'):.2f} s); level "
                f"{bm.BTS_LEVEL} -> {ct.level}; decodes within {e:.3e} "
                f"(limit {BTS_TOL})")
            if not e < BTS_TOL:
                raise AssertionError(f"{name} ({run}) decodes with error "
                                     f"{e}")
    out["bootstrap_s"] = bts
    out["launches"] = read_counters()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if gpu \
        else 0.0
    out["keys_held"] = len(ctx.keygen._rot_keys)
    out["key_bytes"] = ctx.key_memory_bytes()
    log(f"[phase 10] launches in (c)-(e): {out['launches']}; "
        f"{out['keys_held']} rotation keys held, all keys "
        f"{out['key_bytes']} B; peak device memory "
        f"{out['peak_gib']:.2f} GiB")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the evaluator's op programs
# ---------------------------------------------------------------------------

PROGRAM_REPS = 5   # timed calls of each kind, eager and replayed
RMGM_ROTS = 12     # the conv bundle at max_bundle_msg rotations


def program_cases(ctx, rng) -> dict:
    """kind -> (make, run): make() draws fresh inputs at the top level
    (ciphertexts of uniform(-1, 1) messages, plaintexts, int64 weight
    messages of up to 2^40), run(ev, *inputs) calls the kind's public op
    on evaluator ev and returns its ciphertexts."""
    import torch
    ev, enc = ctx.evaluator, ctx.encoder
    n = ctx.params.degree

    def vec():
        return rng.uniform(-1, 1, n // 2).astype(np.complex128)

    def ct():
        return ev.encrypt(enc.encode(vec()))

    def msgs(g, r):
        return torch.as_tensor(rng.integers(-(1 << 40), 1 << 40, (g, r, n)),
                               device=ctx.device)

    def ext():
        return enc.encode(vec(), extended=True)

    return {
        "rot": (lambda: (ct(),), lambda e, a: [e.rotate(a, 1)]),
        "conj": (lambda: (ct(),), lambda e, a: [e.conjugate(a)]),
        "mulrl": (lambda: (ct(), ct()), lambda e, a, b: [e.mul(a, b)]),
        "rs": (lambda: (ct(),), lambda e, a: [e.rescale(a)]),
        "mp": (lambda: (ct(), enc.encode(vec())),
               lambda e, a, p: [e.mul_plain(a, p)]),
        "addc": (lambda: (ct(), float(rng.uniform(-1, 1))),
                 lambda e, a, v: [e.add_const(a, v)]),
        "rsum": (lambda: (ct(), ct()),
                 lambda e, a, b: [e.rot_sum_jit([(a, 1), (b, 0), (a, 2)])]),
        "rmg": (lambda: (ct(), [[ext(), None, ext()], [ext(), ext(), None]]),
                lambda e, a, g: e.rot_ext_mac_groups_jit(a, [0, 1, 2], g)),
        "rmgm": (lambda: (ct(), msgs(4, RMGM_ROTS)),
                 lambda e, a, m: e.rot_mac_groups_msgs_jit(
                     a, list(range(RMGM_ROTS)), m)),
        "bsgs": (lambda: (ct(), msgs(4, 4)),
                 lambda e, a, m: [e.bsgs_iter_jit(a, [0, 1, 2, 3],
                                                  [0, 4, 8, 12], m)]),
    }


def _equal_cts(got: list, want: list) -> bool:
    import torch
    return len(got) == len(want) and all(
        torch.equal(g.c0.data, w.c0.data) and torch.equal(g.c1.data,
                                                          w.c1.data)
        for g, w in zip(got, want))


def time_call(fn, reps: int, device) -> tuple:
    """(host ms, device ms) medians of `reps` calls of fn: the host clock
    around the call and a synchronize, CUDA events around the call
    (None on the CPU)."""
    import torch
    from ace_tpu_torch.utils.card import syncer
    sync = syncer(device)
    gpu = torch.device(device).type == "cuda"
    wall, dev = [], []
    for _ in range(reps):
        sync()
        if gpu:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        fn()
        if gpu:
            b.record()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        if gpu:
            dev.append(a.elapsed_time(b))
    return statistics.median(wall), statistics.median(dev) if gpu else None


def phase_programs(ctx, slice_res: dict, bts: dict,
                   reps: int = PROGRAM_REPS) -> dict:
    """The evaluator's op programs (ckks/evaluator.py, utils/liftgraph.py)
    on phase 5's context (ResNet-20's ring: N = 2^15, 34 q + 12 P
    primes, 3 digits; its keys held) against Evaluator(programs=False)
    on the same keys:
      a. each program kind (rot and a conjugate through it, mulrl, rs,
         mp, addc, rsum, rmg, rmgm at 12 rotations, bsgs) called three
         times on fresh inputs (call 1 runs eagerly, call 2 captures and
         replays, call 3 replays); each result equal word for word to
         the eager evaluator's on the same inputs, and each call's
         kernel-counter growth equal to the eager call's;
      b. each kind's eager call and replay timed (time_call: host clock,
         CUDA events);
      c. phase 5's bootstrap a third time (replayed) against the eager
         evaluator's on the same input: equal residues, both decoded
         within 2e-2, each timed and then profiled for the device's idle
         share (profile_inference);
      d. phase 4's ops[:6] on its first input ciphertext through its
         model's programs (captured by phase 4's second inference): equal
         to phase 4's output residues.
    Returns the programmed runs' kernel launches (launches_programs) and
    the phase's measurements; main() fails unless every kernel
    launched."""
    import collections
    import torch
    from ace_tpu_torch.ckks.bootstrap import BootstrapContext
    from ace_tpu_torch.ckks.evaluator import Evaluator
    from ace_tpu_torch.ops import counter_state, modops, reset_counters
    from ace_tpu_torch.utils.card import syncer

    dev = ctx.device
    sync = syncer(dev)
    ev = ctx.evaluator
    eager = Evaluator(ctx.params, ctx.keygen, ctx.encoder, programs=False)
    launches = collections.Counter()

    def counted(e, fn, *ins):
        reset_counters()
        out = fn(e, *ins)
        sync()
        return out, counter_state()

    def add_launches(state):
        for (k, attr), v in state.items():
            if attr == "launches":
                launches[k] += v

    kg = ctx.keygen  # every key first: key generation launches kernels too
    for r in sorted({1, 2, 4, 8, 12, *range(RMGM_ROTS)} - {0}):
        kg.rot_key(r)
    kg.conj_key()
    rng = np.random.default_rng(SEED + 11)
    cases = program_cases(ctx, rng)
    out = {"kinds": {}}
    for kind, (make, fn) in cases.items():
        for call in range(1, 4):
            ins = make()
            got, c_prog = counted(ev, fn, *ins)
            want, c_eager = counted(eager, fn, *ins)
            if not _equal_cts(got, want):
                raise AssertionError(f"program {kind}, call {call}: "
                                     f"differs from the eager path")
            if c_prog != c_eager:
                raise AssertionError(f"program {kind}, call {call}: "
                                     f"counters {c_prog} != eager "
                                     f"{c_eager}")
            add_launches(c_prog)
        ins = make()
        e_ms = time_call(lambda: fn(eager, *ins), reps, dev)
        r_ms = time_call(lambda: fn(ev, *ins), reps, dev)
        n_launch = sum(v for (_, a), v in c_prog.items() if a == "launches")
        out["kinds"][kind] = {"eager_ms": e_ms, "replay_ms": r_ms,
                              "kernel_launches": n_launch}
        log(f"[phase 11] (a) {kind}: 3 calls equal to the eager path word "
            f"for word, counters equal ({n_launch} K1-K4 launches a "
            f"call); (b) eager {e_ms[0]:.3f} ms host"
            + (f" / {e_ms[1]:.3f} ms events" if e_ms[1] is not None else "")
            + f", replay {r_ms[0]:.3f} ms host"
            + (f" / {r_ms[1]:.3f} ms events" if r_ms[1] is not None else "")
            + f" (x{e_ms[0] / r_ms[0]:.1f} host)")
    out["a_stats"] = ev.program_stats()
    log(f"[phase 11] (a) programs: {out['a_stats']}")

    ct, msg = bts["input"], bts["msg"]
    bc = BootstrapContext(eager, ct.slots)
    runs = {}
    for name, f in (("programs", lambda: ctx.bootstrap(ct)),
                    ("eager", lambda: bc.bootstrap(ct))):
        reset_counters()
        t0 = time.perf_counter()
        res = f()
        sync()
        secs = time.perf_counter() - t0
        if name == "programs":
            add_launches(counter_state())
        ctx.set_output_data("bts11", res)
        err = float(np.max(np.abs(ctx.handle_output("bts11") - msg)))
        prof = {}
        profile_inference(f, secs, f"[phase 11] (c) {name}:", dev, prof)
        runs[name] = {"s": secs, "max_err": err, "out": res,
                      "idle": prof.get("idle"),
                      "profiled_wall_s": prof.get("wall_s"),
                      "busy_s": prof.get("busy_s")}
        log(f"[phase 11] (c) warm bootstrap, {name}: {secs:.3f} s, decoded "
            f"within {err:.3e} (limit {BTS_TOL})")
        if not err < BTS_TOL:
            raise AssertionError(f"bootstrap ({name}) decodes with error "
                                 f"{err}")
    if not _equal_cts([runs["programs"]["out"]], [runs["eager"]["out"]]):
        raise AssertionError("the replayed bootstrap differs from the "
                             "eager one")
    for r in runs.values():
        del r["out"]
    out["bootstrap"] = runs
    log(f"[phase 11] (c) replayed bootstrap == eager bootstrap, residue for "
        f"residue; x{runs['eager']['s'] / runs['programs']['s']:.2f}")

    model = slice_res["model"]
    reset_counters()
    t0 = time.perf_counter()
    got = model.runner.run(slice_res["input"])
    sync()
    secs = time.perf_counter() - t0
    add_launches(counter_state())
    c0, c1 = slice_res["residues"]
    if not (np.array_equal(modops.to_numpy(got.c0.data), c0)
            and np.array_equal(modops.to_numpy(got.c1.data), c1)):
        raise AssertionError("ops[:6] through programs differs from phase "
                             "4's output residues")
    st = model.ctx.evaluator.program_stats()
    out["slice"] = {"s": secs, "stats": st}
    log(f"[phase 11] (d) ops[:6] replayed on phase 4's input in "
        f"{secs:.2f} s: equal to phase 4's output residues; its programs "
        f"{st}")
    out["launches_programs"] = dict(launches)
    out["stats"] = ev.program_stats()
    log(f"[phase 11] launches through programs {dict(launches)}; "
        f"programs {out['stats']}")
    return out


def main() -> int:
    try:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                  "false)", file=sys.stderr)
            return 1
        sys.path.insert(0, REPO)
        import ace_tpu_torch  # noqa: F401  (fails outside the repo)
        t_start = time.perf_counter()
        secs = {}  # seconds of each phase

        def lap(phase: str) -> None:
            secs[phase] = time.perf_counter() - t_start - sum(secs.values())

        dev = phase_device_and_build()
        lap("1")
        from ace_tpu_torch.poly.rns import CrtContext
        t0 = time.perf_counter()
        crt = CrtContext(NUM_Q, 60, 56, DEGREE, Q_PARTS, device="cuda")
        crt.ntt_tables  # noqa: B018  (builds the tables)
        log(f"[phase 2] CRT context and NTT tables "
            f"{time.perf_counter() - t0:.1f} s")
        rows = phase_kernels(crt)
        lap("2")
        phase_ops_exact()
        lap("3")
        sm = slice_model()
        res = phase_slice(sm)
        lap("4")
        log(f"[summary] ops[:6]: context {res['context_s']:.2f} s, "
            f"inference {res['inference_s']:.2f} s (rotation keygen "
            f"{res['rot_keygen_s']:.2f} s), warm inference "
            f"{res['warm_inference_s']:.2f} s, max_err "
            f"{res['max_err']:.3e} of max|plain| {res['max_plain']:.3f}")
        bts = phase_bootstrap()
        lap("5")
        log(f"[summary] bootstrap: cold {bts['cold_s']:.2f} s, warm "
            f"{bts['warm_s']:.2f} s, max_err {bts['max_err']:.3e}")
        prog = phase_programs(bts["ctx"], res, bts)
        lap("11")
        idle = [k for k, v in prog["launches_programs"].items() if v == 0]
        if idle or len(prog["launches_programs"]) < 4:
            raise AssertionError(f"kernels never launched through programs "
                                 f"in phase 11: {prog['launches_programs']}")
        pb = prog["bootstrap"]
        log(f"[summary] op programs: " + ", ".join(
            f"{k} {v['eager_ms'][0]:.2f} -> {v['replay_ms'][0]:.2f} ms"
            for k, v in prog["kinds"].items())
            + f"; warm bootstrap eager {pb['eager']['s']:.3f} s (idle "
            f"{pb['eager']['idle']}), programs {pb['programs']['s']:.3f} s "
            f"(idle {pb['programs']['idle']}); ops[:6] replayed "
            f"{prog['slice']['s']:.2f} s; programs {prog['stats']}")
        for key in ("model", "input"):  # free phase 4's context
            del res[key]
        del bts["ctx"]
        full = phase_resnet20()
        lap("6")
        idle = [k for k, v in full["launches"].items() if v == 0]
        if idle:
            raise AssertionError(f"kernels never launched in ResNet-20: "
                                 f"{idle}")
        launches = {"launches": full["launches"]}
        log(f"[summary] ResNet-20: cold {full['cold_s']:.1f} s ("
            f"{full['keys']} rotation keys {full['rot_keygen_s']:.1f} s), "
            f"max_err {full['max_err']:.3e} "
            f"of max|plain| {full['max_plain']:.3f}, peak "
            f"{full['peak_gib']:.2f} GiB allocated, "
            f"{full['peak_reserved_gib']:.2f} GiB reserved; total "
            f"{time.perf_counter() - t_start:.1f} s on {dev['card']}")
        from ace_tpu_torch.compiler.relu_ranges import ranges_for
        from ace_tpu_torch.models import resnet as M
        g = M.build_resnet_cifar(3)
        img = np.random.default_rng(0).uniform(-1.5, 1.5, (1, 3, 32, 32))[0]
        vr_default, vr = M.calibrate_relu_ranges(
            g, [img], *ranges_for("resnet20_cifar10"))
        t0 = time.perf_counter()
        svc = phase_runtime_services(g, img, vr_default, vr)
        lap("7")
        idle = [k for k, v in svc["launches"].items() if v == 0]
        if idle:
            raise AssertionError(f"kernels never launched in phase 7: "
                                 f"{idle}")
        log(f"[summary] runtime services {time.perf_counter() - t0:.1f} s: "
            f"compile {svc['compile_s']:.2f} s ({svc['rotations']} "
            f"rotations), {svc['s_per_key']:.3f} s a pre-warmed key, "
            f"{svc['key_hits']} manifest keys used, validated "
            f"ops[:{VALIDATED_OPS}] {svc['checks']} checks in "
            f"{svc['validated_s']:.2f} s, checkpoint {svc['ckpt_bytes']} "
            f"bytes (save {svc['ckpt_save_s']:.3f} s, load "
            f"{svc['ckpt_load_s']:.3f} s), loader {svc['bio_engine']}; "
            f"script {time.perf_counter() - t_start:.1f} s")
        t0 = time.perf_counter()
        att = phase_attention()
        lap("8")
        # the block has no MAC bundle (its products are mul_plain), so no
        # message lift (K6)
        idle = [k for k, v in att["launches"].items() if v == 0 and k != "K6"]
        if idle:
            raise AssertionError(f"kernels never launched in the attention "
                                 f"block: {idle}")
        launches["launches_llama"] = att["launches"]
        rows += att["kernel_rows"]
        log(f"[summary] attention block (seq {ATTN_SEQ}, d {ATTN_D}, "
            f"{ATTN_NUM_Q} q primes): cold {att['block_s']:.1f} s ("
            f"{att['keys']} rotation keys {att['keys_s']:.1f} s), "
            f"{att['rotations']} rotations, level {att['level_in']} -> "
            f"{att['level_out']}, max_err {att['max_err']:.3e} of max|plain| "
            f"{att['max_plain']:.3f}, peak {att['peak_gib']:.2f} GiB; one "
            f"projection {att['projection_s']:.2f} s; phase "
            f"{time.perf_counter() - t0:.1f} s; script "
            f"{time.perf_counter() - t_start:.1f} s")
        del att
        spmd = phase_spmd(sm=sm, want=res["residues"])
        lap("9")
        launches["launches_spmd"] = spmd["launches_spmd"]
        log(f"[summary] SPMD key switch: worlds 9a {spmd['seconds']['9a']:.1f}"
            f" s, 9b {spmd['seconds']['9b']:.1f} s, 9c "
            f"{spmd['seconds']['9c']:.1f} s; launches in 9a-9b over all "
            f"ranks {spmd['launches_spmd']}, through programs "
            f"{spmd['launches_programs']}; "
            + mesh_summary(spmd["ranks"]["9a"], spmd["ranks"]["9b"]))
        limb = phase_limb(sm=sm, want=res["residues"])
        lap("9d")
        launches["launches_limb"] = limb["launches_limb"]
        launches["launches_mesh_programs"] = {
            k: v + limb["launches_programs"][k]
            for k, v in spmd["launches_programs"].items()}
        idle = [k for k, v in launches["launches_mesh_programs"].items()
                if not v]
        if idle:
            raise AssertionError(f"kernels never launched through programs "
                                 f"in phases 9a-9d: {idle}")
        log(f"[summary] limb-sharded evaluator: world 9d "
            f"{limb['seconds']['9d']:.1f} s; launches in 9d over all ranks "
            f"{limb['launches_limb']}, fewest on a rank "
            f"{limb['launches_min']}, through programs "
            f"{limb['launches_programs']}; "
            + mesh_summary(limb["ranks"], limb["ranks"]))
        bench = phase_bench()
        lap("10")
        idle = [k for k, v in bench["launches"].items() if v == 0]
        if idle:
            raise AssertionError(f"kernels never launched in phase 10: "
                                 f"{idle}")
        launches["launches_2e16"] = bench["launches"]
        launches["launches_programs"] = prog["launches_programs"]
        rows += bench["kernel_rows"]
        (k3, k4), bs = bench["kernel_rows"][:2], bench["bootstrap_s"]
        log(f"[summary] benchmark entry points at N = 2^16: bench_torch "
            f"--ntt {bench['bench_ntt']['value']} NTT/s (vs_baseline "
            f"{bench['bench_ntt']['vs_baseline']}); K3/K4 at [8, 65536] "
            f"{k3['ms']:.4f} / {k4['ms']:.4f} ms; context "
            f"{bench['context_s']:.1f} s; rotate "
            f"{bench['ops_ms']['rotate']:.2f} ms; bootstrap full cold / "
            f"warm {bs['bootstrap_full_cold']:.1f} / "
            f"{bs['bootstrap_full_warm']:.1f} s, sparse {BENCH_SPARSE} "
            f"cold {bs[f'bootstrap_sparse_{BENCH_SPARSE}_cold']:.1f} s; "
            f"peak {bench['peak_gib']:.2f} GiB; launches "
            f"{bench['launches']}")
        log("[summary] phase seconds " + ", ".join(
            f"{k}: {v:.1f}" for k, v in secs.items())
            + f"; script {time.perf_counter() - t_start:.1f} s on "
            f"{dev['card']}")
        print(dev["card"])
        print(json.dumps({"kernels": kernel_table(rows, launches)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
