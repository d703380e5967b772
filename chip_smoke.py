#!/usr/bin/env python3
"""Drive the PyTorch port (ace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Four phases; any failure exits non-zero and prints no result line.
  1. device and build: the card's name and power limit; the CUDA kernels
     compiled from ace_tpu_torch/csrc (one nvcc per source, in parallel).
  2. kernels: K1 (Barrett product), K2 (Shoup product), K3 (forward NTT)
     and K4 (inverse NTT) at ResNet-20's shapes — N = 2^15 over its whole
     prime chain (34 q primes and the P primes) — each equal, word for
     word, to its plain PyTorch version on the same inputs, plus the
     K3-K4 round trip; then each kernel's time (CUDA events, see
     phase_kernels), its plain version's time, launch shape and bound.
  3. exactness of whole ops: one rotate and one mul+rescale of a level-34
     ciphertext under the port's own keys, on the card and on the CPU
     (plain versions); the residues must be identical.
  4. the slice: ResNet-20's first residual block (ops[:6] of
     build_resnet_cifar(3), output /layer1/layer1.0/Add_output_0)
     encrypted at N = 2^15 with a 34-prime chain, through compile_model
     and infer_encrypted, against infer_plain; every kernel's launch
     counter must grow during the inference.

The last lines are the card's `name, power.limit`, one JSON object with a
row per kernel, and {"ok": true, "device": {...}}.
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


def counters() -> dict:
    from ace_tpu_torch.ops import ntt4, pallas_modops as pm
    return {"K1": pm.barrett_mul, "K2": pm.shoup_mul, "K3": ntt4.ntt4_fwd,
            "K4": ntt4.ntt4_inv}


def reset_counters() -> None:
    for w in counters().values():
        w.launches = 0


def read_counters() -> dict:
    return {k: w.launches for k, w in counters().items()}


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device_and_build() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"[phase 1] card: {card}")
    log(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from ace_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    times = kernels.build_all(verbose=True)
    log(f"[phase 1] built {sorted(times)} in "
        f"{time.perf_counter() - t0:.1f} s into {kernels.build_dir()}")
    return {"card": card}


# ---------------------------------------------------------------------------
# Phase 2: the four kernels at ResNet-20's shapes
# ---------------------------------------------------------------------------

def phase_kernels(crt) -> list:
    """Each kernel against its plain version on the same card tensors,
    then timed. `ms` is the kernel alone: 20 back-to-back launches through
    the C launcher between two CUDA events, cycling over 4 input sets
    (4 x 24-36 MB, beyond the 50 MB L2, so each launch reads cold data),
    median of 10 such samples. The wrapper's time per single call (with
    its argument checks and Python overhead) and the plain version's
    are printed beside it."""
    import torch
    from ace_tpu_torch.ops import (kernels, modops, ntt, ntt4,
                                   pallas_modops as pm)
    dev = crt.device
    primes = crt.all_primes
    L, n = len(primes), crt.degree
    logn = n.bit_length() - 1
    rng = np.random.default_rng(SEED)

    def residues():
        return modops.to_torch(np.stack([
            rng.integers(0, q, n, dtype=np.uint64) for q in primes]), dev)

    sets = [(residues(), residues()) for _ in range(4)]
    a, b = sets[0]
    out = torch.empty_like(a)
    q, mu_hi, mu_lo = crt.mod_arrays(range(L))
    ws = [int(rng.integers(1, p)) for p in primes]
    w = crt.column(ws)
    wp = crt.column([modops.precompute_shoup(v, p)
                     for v, p in zip(ws, primes)])
    t = crt.tables_for(range(L))
    log(f"[phase 2] shapes [{L}, {n}] int64 (uint64 residues), "
        f"{L} primes of {min(p.bit_length() for p in primes)}-"
        f"{max(p.bit_length() for p in primes)} bits")

    mm, nt_ = kernels.lib("modmul"), kernels.lib("ntt")
    st = kernels.stream_ptr(a)
    ptr = [(x.data_ptr(), y.data_ptr()) for x, y in sets]
    qp, mhp, mlp = q.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr()
    tp = {k: getattr(t, k).data_ptr() for k in (
        "rou", "rou_prec", "rou_inv", "rou_inv_prec", "q", "n_inv",
        "n_inv_prec", "rows")}
    op = out.data_ptr()
    raw = {
        "K1": lambda i: mm.ace_k1_barrett_mul(
            *ptr[i % 4], qp, mhp, mlp, op, L, logn, 0, st),
        "K2": lambda i: mm.ace_k2_shoup_mul(
            ptr[i % 4][0], w.data_ptr(), wp.data_ptr(), qp, op, L, logn, st),
        "K3": lambda i: nt_.ace_k3_ntt_fwd(
            ptr[i % 4][0], op, tp["rou"], tp["rou_prec"], tp["q"],
            tp["rows"], L, logn, st),
        "K4": lambda i: nt_.ace_k4_ntt_inv(
            ptr[i % 4][0], op, tp["rou_inv"], tp["rou_inv_prec"], tp["q"],
            tp["n_inv"], tp["n_inv_prec"], tp["rows"], L, logn, st),
    }
    grid = min((L * n + 255) // 256, 132 * 64)
    passes = (f"{2 if n > 4096 else 1} pass(es), grid "
              f"({max(1, n // 4096)}, {L}) x 256 threads, 32 KB static smem")
    cases = [
        ("K1", "barrett_mul", lambda: pm.barrett_mul(a, b, q, mu_hi, mu_lo),
         lambda: pm.barrett_mul_plain(a, b, q, mu_hi, mu_lo),
         "ace_tpu_torch/csrc/modmul.cu",
         "ace_tpu/ops/pallas_modops.py:246",
         3 * L * n * 8, BARRETT_IMAD * L * n,
         f"grid {grid} x 256 threads, grid-stride"),
        ("K2", "shoup_mul", lambda: pm.shoup_mul(a, w, wp, q),
         lambda: pm.shoup_mul_plain(a, w, wp, q),
         "ace_tpu_torch/csrc/modmul.cu",
         "ace_tpu/ops/pallas_modops.py:229",
         2 * L * n * 8, SHOUP_IMAD * L * n,
         f"grid {grid} x 256 threads, grid-stride"),
        ("K3", "ntt4_fwd", lambda: ntt4.ntt4_fwd(a, t),
         lambda: ntt.ntt_fwd_plain(a, t),
         "ace_tpu_torch/csrc/ntt.cu", "ace_tpu/ops/ntt4.py:510",
         4 * L * n * 8, SHOUP_IMAD * L * (n // 2) * logn, passes),
        ("K4", "ntt4_inv", lambda: ntt4.ntt4_inv(a, t),
         lambda: ntt.ntt_inv_plain(a, t),
         "ace_tpu_torch/csrc/ntt.cu", "ace_tpu/ops/ntt4.py:515",
         4 * L * n * 8, SHOUP_IMAD * L * (n // 2) * (logn + 2), passes),
    ]
    rows = []
    for key, name, kern, plain, src, repl, nbytes, imads, shape in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got != want).sum().item())
        if err:
            raise AssertionError(f"{key} {name}: {err} residues differ "
                                 f"from the plain version")

        def launch(i, f=raw[key], what=f"{key} {name}"):
            kernels.check(f(i), what)
        ms = time_ms(launch, reps=10, batch=20)
        wrap_ms = time_ms(lambda i: kern(), reps=10)
        plain_ms = time_ms(lambda i: plain(), reps=10)
        b_ms, b_by = bound(nbytes, imads)
        log(f"[phase 2] {key} {name}: exact; kernel {ms:.4f} ms "
            f"(wrapper call {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms); "
            f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
            f"{imads / 1e6:.1f} M IMAD) = {100 * b_ms / ms:.0f}% of "
            f"roofline; {shape}")
        rows.append({"name": f"{key} {name}", "route": "cuda",
                     "source": src, "replaces": repl, "launches": 0,
                     "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    back = ntt4.ntt4_inv(ntt4.ntt4_fwd(a, t), t)
    if not torch.equal(back, a):
        raise AssertionError("K4(K3(x)) != x")
    log("[phase 2] K4(K3(x)) == x")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: whole ops, card against CPU
# ---------------------------------------------------------------------------

def phase_ops_exact() -> None:
    import torch
    from ace_tpu_torch import interop
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
    auto_idx, rkey = kg.rot_key(rot)
    rng = np.random.default_rng(SEED + 1)
    m = rng.uniform(-1, 1, DEGREE // 2)
    ct = ev.encrypt(enc.encode(m.astype(np.complex128)))
    assert ct.level == NUM_Q
    rot_g = ev.rotate(ct, rot)
    mul_g = ev.rescale(ev.mul(ct, ct))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0

    t0 = time.perf_counter()
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
        log(f"[phase 3] {what} at level {ct.level}: card == CPU, "
            f"residue for residue")
    dec = enc.decode(ev.decrypt(rot_g)).real
    err = float(np.max(np.abs(dec - np.roll(m, -rot))))
    if not err < 1e-3:
        raise AssertionError(f"rotate decodes with error {err}")
    log(f"[phase 3] card {t_gpu:.1f} s (keys + ops), CPU "
        f"{time.perf_counter() - t0:.1f} s; rotate decodes to "
        f"roll(m, -1) within {err:.2e}")


# ---------------------------------------------------------------------------
# Phase 4: ResNet-20's first residual block, encrypted
# ---------------------------------------------------------------------------

def phase_slice() -> dict:
    import torch
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import (SchemeConfig,
                                                    select_params)
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.runtime.timing import TIMING

    TIMING.enabled = True
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
    t0 = time.perf_counter()
    ctx = FheContext(scheme_info=info, max_rot_keys=100)
    torch.cuda.synchronize()
    t_ctx = time.perf_counter() - t0
    crt = ctx.params.crt
    log(f"[phase 4] context {t_ctx:.1f} s: N={ctx.params.degree}, "
        f"{crt.num_q} q primes + {crt.num_p} P primes, "
        f"{ctx.params.num_q_parts} digits")
    out_len = 16 * 32 * 32
    model = M.compile_model(g, cfg, ctx=ctx, num_classes=out_len, trace=log)

    reset_counters()
    TIMING.reset()
    t0 = time.perf_counter()
    out = M.infer_encrypted(model, img)
    torch.cuda.synchronize()
    t_inf = time.perf_counter() - t0
    launches = read_counters()
    t_keys = TIMING.seconds("RTM_ROT_KEY_REGEN")
    log(f"[phase 4] inference {t_inf:.1f} s, of which rotation-key "
        f"generation {t_keys:.1f} s ({TIMING.count('RTM_ROT_KEY_REGEN')} "
        f"keys); launches {launches}")
    log(TIMING.report())

    t0 = time.perf_counter()
    out2 = M.infer_encrypted(model, img)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    log(f"[phase 4] second inference (keys held) {t_warm:.1f} s")
    out3 = profile_inference(lambda: M.infer_encrypted(model, img), t_warm)

    plain = M.infer_plain(g, img, n_slots=DEGREE // 2)[:out_len]
    scale = float(np.max(np.abs(plain)))
    errs = [float(np.max(np.abs(o - plain))) for o in (out, out2, out3)]
    log(f"[phase 4] max_err {errs[0]:.4e} (second run {errs[1]:.4e}, "
        f"profiled run {errs[2]:.4e}), "
        f"max|plain| {scale:.4f}, limit 5e-2 * max|plain| = "
        f"{5e-2 * scale:.4e}")
    log(f"[phase 4] {ctx.hbm_plan()}")
    log(f"[phase 4] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(np.all(np.isfinite(o)) and o.shape == (out_len,)
               for o in (out, out2, out3)):
        raise AssertionError("output is not finite or has the wrong shape")
    if not max(errs) <= 5e-2 * scale:
        raise AssertionError(f"max_err {max(errs)} > 5e-2 * {scale}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched in the slice: {idle}")
    return {"launches": launches, "context_s": t_ctx, "inference_s": t_inf,
            "rot_keygen_s": t_keys, "warm_inference_s": t_warm,
            "max_err": errs[0], "max_plain": scale}


def profile_inference(run, unprofiled_s: float):
    """One more warm inference under torch.profiler: kernel time by name
    and the device's busy share. The profiler slows the host, so the
    busy share is given both over the profiled wall time (the idle share
    of that run) and over `unprofiled_s`, the wall time of an unprofiled
    warm inference (a rough figure for a real one). The inference always
    runs, any failure of it fails the phase, and its output is returned
    for the phase's check; only a profiler that cannot start or reports
    nothing is logged as not measured."""
    import contextlib
    import torch
    stack = contextlib.ExitStack()
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    except Exception as exc:  # noqa: BLE001 — the profiler alone
        log(f"[phase 4] profiler did not start, not measured: {exc!r}")
    with stack:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if prof is None:
        return out
    try:
        from torch.autograd import DeviceType

        def dev_us(e):
            return (getattr(e, "self_device_time_total", 0)
                    or getattr(e, "self_cuda_time_total", 0) or 0)
        # kernels only: an aten op's entry repeats its kernels' time
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    except Exception as exc:  # noqa: BLE001 — the profiler's report alone
        log(f"[phase 4] profile unreadable, not measured: {exc!r}")
        return out
    if not events:
        log("[phase 4] profile: no device time recorded (not measured)")
        return out
    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"[phase 4] profiled warm inference {wall:.2f} s wall, kernels busy "
        f"{busy:.2f} s: idle {100 * (1 - busy / wall):.0f}% of the profiled "
        f"run; busy {100 * busy / unprofiled_s:.0f}% of the unprofiled "
        f"warm inference's {unprofiled_s:.2f} s (rough)")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"[phase 4]   {dev_us(e) / 1e3:10.2f} ms {e.count:7d}x  "
            f"{e.key[:90]}")
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
        dev = phase_device_and_build()
        from ace_tpu_torch.poly.rns import CrtContext
        t0 = time.perf_counter()
        crt = CrtContext(NUM_Q, 60, 56, DEGREE, Q_PARTS, device="cuda")
        crt.ntt_tables  # noqa: B018  (builds the tables)
        log(f"[phase 2] CRT context and NTT tables "
            f"{time.perf_counter() - t0:.1f} s")
        rows = phase_kernels(crt)
        phase_ops_exact()
        res = phase_slice()
        for r in rows:
            r["launches"] = res["launches"][r["name"].split()[0]]
        log(f"[summary] slice: context {res['context_s']:.2f} s, inference "
            f"{res['inference_s']:.2f} s (rotation keygen "
            f"{res['rot_keygen_s']:.2f} s), warm inference "
            f"{res['warm_inference_s']:.2f} s, max_err "
            f"{res['max_err']:.3e} of max|plain| {res['max_plain']:.3f}; "
            f"total {time.perf_counter() - t_start:.1f} s on {dev['card']}")
        print(dev["card"])
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
