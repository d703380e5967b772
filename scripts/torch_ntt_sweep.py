#!/usr/bin/env python3
"""Time kernels K3/K4 (ace_tpu_torch/csrc/ntt.cu) on one CUDA card at
N = 2^15 over a range of limb counts, and show what bounds them.

    python3 scripts/torch_ntt_sweep.py [--limbs 1,2,4,8,9,12,34,46] [--sass]

Prints the card's `name, power.limit` first, then:
  [ptxas]  registers and spill stores of every K3/K4 instantiation
           (ntt.cu built with the library's flags and -Xptxas -v);
  [sass]   with --sass, the SASS opcode mix of the library's N = 2^15
           kernels (clusters of 8 and of 16);
  [probe]  a butterfly ceiling: the same Shoup butterflies
           (csrc/modarith.cuh) on 8 words held in registers, 3 stages a
           round as in a radix-8 group, no memory traffic, no barriers;
           its rate over a full card, the time it implies for the
           butterflies of one [46, 2^15] transform, and the SASS
           instructions of its loop per butterfly;
  one line per (L, kernel): the library's launch (the shape its launcher
  picks for L limbs), held word for word against the plain ladder, then
  timed two ways:
    host    CUDA events around 20 back-to-back launches through the C
            launcher, cycling over 4 input sets, median of 10 (as
            chip_smoke.py phase 2 times them);
    device  torch.profiler's duration of the kernel itself, mean over 40
            launches.
Where host is well above device, the rate at which the host issues
launches sets the time, not the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LIMBS = (1, 2, 4, 8, 9, 12, 34, 46)  # the slice launches 1, 12, 34, 46
HBM_BYTES_PER_S = 3.35e12  # chip_smoke.py's bound, bytes side

# The butterfly ceiling: R rounds of 12 butterflies over a full card of
# 64-register threads; the round loop is kept rolled so that its SASS is
# one round.
PROBE_CU = r"""
#include "modarith.cuh"
__global__ void __launch_bounds__(256, 4)
bfly_probe(u64* out, const u64* w, const u64* wp, u64 q, int rounds) {
    u64 v[8], W[8], WP[8];
    for (int i = 0; i < 8; ++i) {
        v[i] = (threadIdx.x * 8 + i) % q;
        W[i] = w[i];
        WP[i] = wp[i];
    }
#pragma unroll 1
    for (int it = 0; it < rounds; ++it) {
#pragma unroll
        for (int st = 0; st < 3; ++st) {
            const int h = 4 >> st;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int lo = (j / h) * 2 * h + j % h;
                const u64 t = shoup_mul(v[lo + h], W[(1 << st) + j / h],
                                        WP[(1 << st) + j / h], q);
                v[lo + h] = sub_mod(v[lo], t, q);
                v[lo] = add_mod(v[lo], t, q);
            }
        }
    }
    u64 acc = 0;
    for (int i = 0; i < 8; ++i) acc ^= v[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int probe(void* out, const void* w, const void* wp, u64 q,
                     int blocks, int rounds, void* stream) {
    bfly_probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)w, (const u64*)wp, q, rounds);
    return (int)cudaGetLastError();
}
"""


def sweep_dir() -> str:
    from ace_tpu_torch.ops import kernels
    out = os.path.join(kernels.build_dir(), "ntt_sweep")
    os.makedirs(out, exist_ok=True)
    return out


def compile_aux() -> str:
    """Build ntt.cu with -Xptxas -v (printing its registers) and the
    probe, both in parallel; returns the probe's library."""
    from ace_tpu_torch.ops import kernels
    d = sweep_dir()
    src = os.path.join(d, "bfly_probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_CU)
    probe_so = os.path.join(d, "libbfly_probe.so")
    ptxas = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(d, "libntt_v.so"), os.path.join(kernels.CSRC, "ntt.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
                    "-o", probe_so, src], check=True)
    text, _ = ptxas.communicate()
    if ptxas.returncode:
        raise RuntimeError(f"nvcc ntt.cu failed:\n{text}")
    regs = re.findall(r"ntt_clusterILb(\d)ELi(\d)E.*?(\d+) bytes spill "
                      r"stores.*?Used (\d+) registers", text, re.S)
    print("[ptxas] registers (spill stores): " + ", ".join(
        f"{'K4' if inv == '1' else 'K3'} C={1 << int(lc)}: {r} ({sp} B)"
        for inv, lc, sp, r in regs), flush=True)
    return probe_so


def sass(so: str) -> str:
    from ace_tpu_torch.ops import kernels
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, timeout=300).stdout


def functions(text: str):
    """(name, [(address, opcode, operands)], {label: index}) per kernel."""
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        instrs, labels = [], {}
        for ln in fn.splitlines()[1:]:
            m = re.match(r"\s*(\.L_x_\d+):", ln)
            if m:
                labels[m.group(1)] = len(instrs)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)([^;]*)", ln)
            if m:
                instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
        yield fn.split()[0], instrs, labels


def opcode_mix(so: str) -> None:
    """Opcode histogram of the library's N = 2^15 kernels (clusters of 8
    and 16): the instruction mix that bounds an integer-heavy kernel."""
    for name, instrs, _ in functions(sass(so)):
        m = re.match(r"_Z11ntt_clusterILb(\d)ELi([34])E", name)
        if not m:
            continue
        hist = {}
        for _, op, _ in instrs:
            hist[op] = hist.get(op, 0) + 1
        top = sorted(hist.items(), key=lambda kv: -kv[1])[:14]
        print(f"[sass] {'K4' if m.group(1) == '1' else 'K3'} "
              f"C={1 << int(m.group(2))}: {len(instrs)} instructions; "
              + ", ".join(f"{k} {v}" for k, v in top), flush=True)


def loop_body(instrs, labels):
    """The longest backward branch's body: the probe's round loop."""
    at = {a: i for i, (a, _, _) in enumerate(instrs)}
    best = []
    for i, (_, op, rest) in enumerate(instrs):
        if op != "BRA":
            continue
        m = re.search(r"(\.L_x_\d+)", rest)
        h = re.search(r"0x([0-9a-f]+)", rest)
        tgt = labels.get(m.group(1)) if m else (
            at.get(int(h.group(1), 16)) if h else None)
        if tgt is not None and tgt <= i and i + 1 - tgt > len(best):
            best = instrs[tgt:i + 1]
    return best


def butterfly_ceiling(probe_so: str, t, butterflies: int) -> None:
    """Print the probe's instructions per butterfly, its butterfly rate
    and the time that rate implies for `butterflies`."""
    import torch
    from ace_tpu_torch.ops import kernels
    for name, instrs, labels in functions(sass(probe_so)):
        if "bfly_probe" in name:
            body = loop_body(instrs, labels)
            imad = sum(op == "IMAD" for _, op, _ in body)
            print(f"[probe] SASS loop of 12 butterflies: {len(body)} "
                  f"instructions ({len(body) / 12:.1f} per butterfly, loop "
                  f"control included), IMAD {imad} ({imad / 12:.1f} per "
                  f"butterfly)", flush=True)
    lib = ctypes.CDLL(probe_so)
    lib.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_ulonglong,
                                                  ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.probe.restype = ctypes.c_int
    rounds = 2048
    out = torch.empty(132 * 4 * 256, dtype=torch.int64, device="cuda")
    q = int(t.sel("q")[0, 0].item())
    w, wp = t.rou[0], t.rou_prec[0]
    st = kernels.stream_ptr(out)
    for blocks in (132, 132 * 4):  # 8 and 32 warps per SM
        def run(i, blocks=blocks):
            kernels.check(lib.probe(out.data_ptr(), w.data_ptr(),
                                    wp.data_ptr(), q, blocks, rounds, st),
                          "probe")
        ms = host_ms(run, reps=5, batch=3)
        rate = blocks * 256 * rounds * 12 / (ms * 1e-3)
        print(f"[probe] {rate / 1e12:.3f} T butterflies/s with {blocks} "
              f"blocks of 256 threads: {butterflies} butterflies take "
              f"{butterflies / rate * 1e3:.4f} ms", flush=True)


def host_ms(fn, reps=10, batch=20):
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


def device_ms(fn, count=40):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(count):
            fn(i)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if "ntt_cluster" in e.name]
    if not ev:
        return float("nan")
    return sum(e.time_range.elapsed_us() for e in ev) / len(ev) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limbs", default=",".join(map(str, LIMBS)),
                    help="limb counts; beyond 46 the chain's rows repeat")
    ap.add_argument("--sass", action="store_true",
                    help="print the kernels' SASS opcode mix")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from ace_tpu_torch.ops import kernels, modops, ntt, ntt4
    from ace_tpu_torch.poly.rns import CrtContext
    from ace_tpu_torch.utils.card import card
    print(card(), flush=True)
    kernels.build_all()
    probe_so = compile_aux()
    if args.sass:
        opcode_mix(kernels._lib_path("ntt"))
    lib = kernels.lib("ntt")
    crt = CrtContext(34, 60, 56, 32768, 3, device="cuda")
    primes = crt.all_primes
    n = crt.degree
    logn = n.bit_length() - 1
    rng = np.random.default_rng(7)
    sets = [modops.to_torch(np.stack([rng.integers(0, q, n, dtype=np.uint64)
                                      for q in primes]), "cuda")
            for _ in range(4)]
    chains = {1: [33], 12: list(range(34, 46)), 34: list(range(34)),
              46: list(range(46))}
    butterfly_ceiling(probe_so, crt.tables_for(range(46)),
                      46 * (n // 2) * logn)
    for L in map(int, args.limbs.split(",")):
        rows = chains.get(L, [i % 46 for i in range(L)])
        t = crt.tables_for(rows)
        idx = torch.tensor(rows, device="cuda")
        xs = [x.index_select(0, idx) for x in sets]
        out = torch.empty_like(xs[0])
        want = {"K3": ntt.ntt_fwd_plain(xs[0], t),
                "K4": ntt.ntt_inv_plain(xs[0], t)}
        st = kernels.stream_ptr(out)
        p = {k: getattr(t, k).data_ptr() for k in (
            "rou", "rou_prec", "rou_inv", "rou_inv_prec", "q", "n_inv",
            "n_inv_prec", "rows")}
        bound = 4 * L * n * 8 / HBM_BYTES_PER_S * 1e3
        raw = {
            "K3": lambda i: lib.ace_k3_ntt_fwd(
                xs[i % 4].data_ptr(), out.data_ptr(), p["rou"],
                p["rou_prec"], p["q"], p["rows"], L, logn, st),
            "K4": lambda i: lib.ace_k4_ntt_inv(
                xs[i % 4].data_ptr(), out.data_ptr(), p["rou_inv"],
                p["rou_inv_prec"], p["q"], p["n_inv"], p["n_inv_prec"],
                p["rows"], L, logn, st),
        }
        shape = ntt4.launch_shape(L, n)
        for key, f in raw.items():
            def launch(i, f=f, what=f"{key} L={L}"):
                kernels.check(f(i), what)
            launch(0)
            torch.cuda.synchronize()
            if not torch.equal(out, want[key]):
                raise AssertionError(f"{key} L={L} differs from the plain "
                                     f"version")
            h = host_ms(launch)
            d = device_ms(launch)
            print(f"L={L:2d} {key}: host {h:.4f} ms, device {d:.4f} ms, "
                  f"bound {bound:.4f} ms ({100 * bound / d:.0f}% of it on "
                  f"device); cluster {shape['cluster']} x "
                  f"{shape['threads']} threads, "
                  f"{shape['smem_bytes'] // 1024} KB, "
                  f"{shape['resident_k3']}/{shape['resident_k4']} clusters "
                  f"resident (K3/K4)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
