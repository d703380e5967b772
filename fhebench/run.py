"""The benchmark of ace_tpu_torch, encrypted CNN inference on one card.

    python3 fhebench/run.py --workload <config>.<mix> --seed <n>
        --seconds <s> --trace <0|1>

One run of one cell of BENCHMARK.json: make the network's weights and
calibrate them from the configuration's seeds, compile the program, warm
it up on the mix's warm-up images, then send encrypted images back to
back for `--seconds` (the window closes at the end of the first image
that ends at or after it), check every image's decrypted logits against
the plain reference, and print one JSON line: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks`, each compared number with its limit,
which also end standard error. Images are drawn from --seed. A run
without a CUDA card, or with fewer cards than the cell asks for, fails
and prints no result; so does a run whose process holds jax, jaxlib,
flax or ace_tpu once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness's modules are imported as fhebench.*, never by their bare
# names from the script's own directory
sys.path = [ROOT] + [p for p in sys.path
                     if os.path.abspath(p or ".") not in (HERE, ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "ace_tpu")
# intra-op threads of the host's numerical libraries, fixed so that every
# run loads the host alike
HOST_THREADS = 4
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this benchmark must not
    load, compared whole (ace_tpu_torch is not ace_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def smi(fields: str) -> str:
    """nvidia-smi's reading of `fields` on the first card, or why it was
    not read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({exc!r})"


def card_state() -> str:
    """The card's clocks, power, temperature and the reasons its clocks
    are held down, and the host's load: logged beside each window."""
    try:
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
    except OSError:
        load = "not read"
    reasons = smi("clocks_event_reasons.active")
    if reasons.startswith("not read"):
        reasons = smi("clocks_throttle_reasons.active")
    return (f"{smi('clocks.sm,clocks.mem,power.draw,temperature.gpu')}; "
            f"clock reasons {reasons}; "
            f"host load {load}")


def trace_segments(net: list) -> list:
    """The profiled spans of a traced run's first window image, each
    (a, b): from the end of the image's a-th ReLU to the end of its b-th,
    0 the image's start and None its end. They are the head (encryption,
    the stem and its ReLU), each later stage's first ReLU with the
    strided convolution before it, and the tail from the last ReLU
    (pooling, classifier, decryption): every stage, at about a fifth of
    the image's device events."""
    relus = [ly for ly in net if ly.op == "relu"]
    segs = [(0, 1 if relus else None)]
    for k in range(1, len(relus)):
        if (relus[k].cin, relus[k].hw) != (relus[k - 1].cin,
                                           relus[k - 1].hw):
            segs.append((k, k + 1))
    if relus:
        segs.append((len(relus), None))
    merged = [segs[0]]
    for a, b in segs[1:]:
        if merged[-1][1] is None or a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def setup(cell, device, scheme: dict | None = None):
    """The cell's network, its calibrated weights and the compiled
    program (`scheme` in place of the configuration's, for a control).
    Returns (net, weights, program)."""
    import torch
    from fhebench import model, port

    cfg = cell.config
    arch, cal = cfg["architecture"], cfg["calibration"]
    net = model.layers(arch)
    weights = model.make_weights(net, cfg["weights"]["seed"], device)
    cal_gen = torch.Generator(device=device).manual_seed(cal["seed"])
    batch = model.draw_images(cal_gen, cal["images"], arch["image"],
                              cal["low"], cal["high"], device)
    weights = model.calibrate(net, weights, batch, cal["targets"],
                              cal["default"])
    prog = port.Program(net, weights, batch.cpu().numpy(),
                        scheme or cfg["scheme"], arch["classes"], device)
    if scheme is None and prog.ring() != cfg["ring"]:
        raise RuntimeError(f"the program selected the ring {prog.ring()}, "
                           f"the configuration states {cfg['ring']}")
    return net, weights, prog


def images_of(cell, seed: int, device):
    """The run's image source: a function that draws the next image of
    `seed`'s sequence, one image per call."""
    import torch
    from fhebench import model

    arch, mix = cell.config["architecture"], cell.traffic
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda: model.draw_images(gen, 1, arch["image"], mix["low"],
                                     mix["high"], device)[0]


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of `cell` on `device`; returns the result line's object
    (without the device's name and count, which main adds)."""
    import numpy as np
    import torch
    from fhebench import check, devtrace, reference, work
    from fhebench import cells as cells_mod
    from fhebench import port

    mix = cell.traffic
    if (mix.get("loop"), mix.get("clients")) != ("closed", 1):
        raise ValueError(f"mix {mix['name']!r}: only a closed loop of one "
                         f"client is served, not loop {mix.get('loop')!r}, "
                         f"clients {mix.get('clients')!r}")
    outputs = cell.config["architecture"]["classes"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    net, weights, prog = setup(cell, device)
    ring = prog.ring()

    draw = images_of(cell, seed, device)
    images, outs = [], []

    def send():
        img = draw()
        images.append(img)
        outs.append(prog.infer(img.cpu().numpy()))

    for _ in range(mix["warmup_images"]):
        send()
    log(f"# ring {ring}; warm-up images {mix['warmup_images']}")

    ins = port.Instruments(cuda) if trace else None
    segs = trace_segments(net) if trace else []
    starts, stops = dict(segs), {b for _, b in segs}
    # the profiled spans: their profilers, summed seconds and NTT limbs,
    # and the seconds spent starting and stopping the profiler, which the
    # window's time leaves out
    prof = {"done": [], "window_s": 0.0, "limbs": 0, "overhead_s": 0.0}

    def prof_start():
        from torch.profiler import ProfilerActivity, profile
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        prof["p"] = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof["p"].start()
        prof["limbs0"] = sum(port.kernel_limbs().values())
        prof["t0"] = time.perf_counter()
        prof["overhead_s"] += prof["t0"] - t

    def prof_stop():
        if "p" not in prof:
            return
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        prof["window_s"] += t - prof["t0"]
        prof["limbs"] += sum(port.kernel_limbs().values()) - prof["limbs0"]
        prof["p"].stop()
        prof["done"].append(prof.pop("p"))
        prof["overhead_s"] += time.perf_counter() - t

    def on_relu(k):
        if k in stops:
            prof_stop()
        if k in starts:
            prof_start()

    n, window_s, image_s = 0, 0.0, []
    if cuda:
        log(f"# card at the window's start: {card_state()}")
    with (ins.installed() if trace else contextlib.nullcontext()):
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            t_image = time.perf_counter()
            if trace:
                ins.start_image()
                if n == 0:
                    ins.on_relu = on_relu
                    if 0 in starts:
                        prof_start()
            send()
            n += 1
            if trace:
                prof_stop()
                ins.on_relu = None
                ins.end_image()
            image_s.append(time.perf_counter() - t_image)
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
    if cuda:
        log(f"# card at the window's end: {card_state()}")
    timed_s = window_s - prof["overhead_s"]
    s_per_image = timed_s / n

    peak = torch.cuda.max_memory_reserved() if cuda else 0
    stats = prog.stats()
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    refs = reference.forward(net, weights, torch.stack(images), outputs)
    correct, checks, gaps = check.judge(np.stack(outs), refs.cpu().numpy(),
                                        cell.limits)
    limit = checks["logit_gap"]["limit"]
    window_gaps = gaps[mix["warmup_images"]:]
    log(f"# images: warm-up {mix['warmup_images']}, window {n} in "
        f"{window_s:.3f} s (each " + " ".join(f"{t:.3f}" for t in image_s)
        + " s); logit gap per image " + " ".join(f"{g:.6g}" for g in gaps))

    result = {"correct": correct, "attempted": n,
              "failed": sum(g > limit for g in window_gaps)}
    device_info = {"memory_peak_bytes": int(peak)}
    if not trace:
        e2e = {"s_per_image": s_per_image, "peak_reserved_gib": peak / GIB,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        t = time.perf_counter()
        tr = devtrace.merge([devtrace.reduce(
            p.profiler.kineto_results.events()) for p in prof["done"]])
        log(f"# trace: spans {segs}, {prof['window_s']:.3f} s; "
            f"{tr.events if tr else 0} device events read in "
            f"{time.perf_counter() - t:.1f} s; profiler started and "
            f"stopped in {prof['overhead_s']:.1f} s")
        rg = work.Ring(ring["degree"], ring["num_q"], ring["num_p"],
                       ring["q_parts"])
        per_image = work.Work()
        for lg in ins.logs:
            per_image += work.total(lg, rg)
        per_image = per_image.scaled(1.0 / n)
        least, bound_by = per_image.least_s(rg)
        log(f"# work per image: {per_image.nbytes(rg):.6g} B, "
            f"{per_image.imads(rg):.6g} IMAD: least {least:.6g} s, "
            f"bound by {bound_by}")
        run = types.SimpleNamespace(
            cuda=cuda, images=n, s_per_image=s_per_image,
            spans=ins.images, programs=stats["programs"],
            key_bytes=stats["key_bytes"], trace=tr,
            trace_window_s=prof["window_s"],
            ntt_limbs=prof["limbs"], ring=rg, work=per_image)
        metrics = {}
        for m in cell.per_layer:
            v = cells_mod.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None and cuda:
            device_info.update(busy_s=tr.busy_s,
                               window_s=prof["window_s"])
            result["breakdown"] = {
                "device_ops": devtrace.top_ops(tr),
                "idle_gaps": [[name, s] for name, s in tr.gaps]}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fhebench import cells
    cell = cells.load(args.workload)

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    import torch
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"fhebench: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count = {torch.cuda.device_count()}. Not run.")
        return 2
    log(f"# card: {smi('name,power.limit')}; host threads {HOST_THREADS}")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    found = forbidden_modules()
    if found:
        log(f"fhebench: the process holds {found} after the window; "
            "no result")
        return 3
    print(result_line(res, torch.cuda.get_device_name(), cell.chips),
          flush=True)
    return 0


def result_line(res: dict, kind: str, count: int) -> str:
    """The last line of standard output, with `checks` last; the checks
    also end standard error."""
    res = dict(res)
    checks = res.pop("checks")
    res["device"] = {"platform": "gpu", "kind": kind, "count": count,
                     **res["device"]}
    res["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return json.dumps(res)


if __name__ == "__main__":
    sys.exit(main())
