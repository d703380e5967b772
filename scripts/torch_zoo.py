"""Model-zoo runner through the PyTorch port (ace_tpu_torch): every named
ResNet through ONE shared context — the counterpart of scripts/zoo.py.

Every zoo model selects the same ring (N = 2^15), so one FheContext sized
to the largest (N, L) serves them all. Images are synthetic,
default_rng(1).uniform(-1.5, 1.5), and each model's ReLU ranges are the
reference's tuned ones widened on those images (calibrate_relu_ranges).
resnet110_cifar10 is built natively with seeded weights; every other name
loads the reference's ONNX export and fails with the missing file's name
where it is absent.

Per model it writes results/torch_<name>.json (the per-image rows, after
every image) and results/torch_accuracy_<name>.json, in zoo.py's schema
plus the card's `name, power.limit` (`card`), the process's peak device
memory (`max_memory_allocated`) and the image's run counters (`stats`:
bootstraps, rotation keys made and their seconds, kernel launches and
NTT limbs, the timing buckets, the encrypted and plain argmax and
logits, max|plain| and the plain top-two margin). The summary also
records the ReLU settings (`relu_depth`, `relu_range`) and the gates
(`gates`, `gates_failed`): after the files are written, each image is
held to finite logits, one bootstrap per ReLU, every kernel launched on
the card, and max_err within MAX_ERR where the model has a bound. A
failed gate ends the run with a non-zero exit.

--max-rot-keys defaults to 0: the rotation-key LRU is sized from
compile_model's device-memory budget (ROT_KEY_BUDGET_BYTES), not capped
at zoo.py's 90 keys.

Usage:
  python scripts/torch_zoo.py [--models resnet110_cifar10,...]
      [--images 1] [--out-dir results] [--max-rot-keys 0]
      [--relu-depth 9] [--relu-range 0] [--device cpu]

--device defaults to the CUDA card and fails without one; --device cpu
runs the plain PyTorch versions of the kernels (hours for a whole model
at N = 2^15).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_MODELS = ("resnet20_cifar10,resnet32_cifar10,resnet32_cifar100,"
                  "resnet44_cifar10,resnet56_cifar10,resnet110_cifar10")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=DEFAULT_MODELS)
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "results"))
    ap.add_argument("--max-rot-keys", type=int, default=0,
                    help="rotation-key LRU capacity (0 = size from the "
                         "device-memory budget)")
    ap.add_argument("--relu-depth", type=int, default=9)
    ap.add_argument("--relu-range", type=float, default=0.0,
                    help="0 = the reference's per-model tuned ranges")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def zoo_images(count: int) -> np.ndarray:
    """The zoo's synthetic inputs, in the data range of normalized CIFAR."""
    return np.random.default_rng(1).uniform(-1.5, 1.5, (count, 3, 32, 32))


def classes_of(name: str) -> int:
    return 100 if "cifar100" in name else 10


# max_err bounds of the zoo's card runs: 1.5 times ace_tpu's TPU run on the
# same graph, image and parameters (results/accuracy_resnet110_cifar10.json:
# 0.875), with other keys.
MAX_ERR = {"resnet110_cifar10": 1.31}


def weights_of(name: str) -> str:
    """resnet110 ships no weight values in the reference: its graph runs
    He-initialized range-calibrated weights (timing is weight-independent),
    labelled so that its agreement is not read as a trained model's."""
    return ("synthetic-calibrated" if name == "resnet110_cifar10"
            else "reference-trained")


def cfg_for(name: str, graph=None, images=None, relu_depth: int = 9,
            relu_range: float = 0.0, hamming_weight: int = 192,
            first_mod_size: int = 60, scaling_mod_size: int = 56):
    """The model's SchemeConfig: the tuned ReLU ranges of `name` (or a
    uniform `relu_range`), widened for the actual inputs when `graph` and
    `images` are given — the tuned ranges assume CIFAR-distributed
    images."""
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import SchemeConfig
    from ace_tpu_torch.models import resnet as M

    vr_default, vr = ranges_for(name)
    if relu_range:
        vr_default, vr = relu_range, {}
    if graph is not None:
        vr_default, vr = M.calibrate_relu_ranges(graph, images, vr_default,
                                                 vr)
    return SchemeConfig(security_level=0, hamming_weight=hamming_weight,
                        first_mod_size=first_mod_size,
                        scaling_mod_size=scaling_mod_size,
                        relu_mul_depth=relu_depth,
                        relu_value_range=vr_default, relu_ranges=vr,
                        use_bootstrap=True)


def shared_context(infos: dict, max_rot_keys: int = 0, device=None):
    """One FheContext for every model of `infos` (name -> SchemeInfo),
    sized to their largest (N, L). Running a shallower model on a longer
    chain is exact. The rotation list is emptied: keys are made on
    demand. max_rot_keys 0 sizes the key LRU from compile_model's
    device-memory budget. Returns (the shared SchemeInfo, the context)."""
    from ace_tpu_torch.models.resnet import ROT_KEY_BUDGET_BYTES
    from ace_tpu_torch.runtime.context import FheContext

    shared = max(infos.values(), key=lambda i: (i.poly_degree, i.mul_level))
    shared = dataclasses.replace(shared, rotate_indices=())
    for name, info in infos.items():
        if not (info.poly_degree == shared.poly_degree
                and info.mul_level <= shared.mul_level):
            raise ValueError(f"{name} params exceed the shared context")
    ctx = FheContext(scheme_info=shared, max_rot_keys=max_rot_keys,
                     rot_key_budget_bytes=0 if max_rot_keys
                     else ROT_KEY_BUDGET_BYTES, device=device)
    return shared, ctx


def measured_infer(model, image):
    """infer_encrypted with the image's counters: kernel launches and the
    NTT kernels' limbs (set to 0 first), and the timing buckets,
    bootstraps and rotation keys it added. Returns (logits, stats)."""
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.ops import kernel_wrappers
    from ace_tpu_torch.runtime.timing import TIMING

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "limbs"):
            w.limbs = 0
    before = TIMING.snapshot()
    logits = M.infer_encrypted(model, image)  # decoded on the host
    timing = {}
    for k, (n, s) in TIMING.snapshot().items():
        n0, s0 = before.get(k, (0, 0.0))
        if n != n0:
            timing[k] = [n - n0, s - s0]
    keys = timing.get("RTM_ROT_KEY_REGEN", [0, 0.0])
    stats = dict(
        bootstraps=timing.get("RTM_BOOTSTRAP", [0])[0],
        rotation_keys=keys[0], rotation_key_seconds=keys[1],
        rotation_keys_held=len(model.ctx.keygen._rot_keys),
        launches={k: w.launches for k, w in wrappers.items()},
        limbs={k: w.limbs for k, w in wrappers.items()
               if hasattr(w, "limbs")},
        timing=timing)
    return logits, stats


def run_model(name, graph, cfg, ctx, images, classes, info=None,
              trace=None, on_row=None) -> list:
    """compile_model on the shared context, then per image infer_plain
    and measured_infer: one row per image in zoo.py's schema (image,
    seconds, max_err, argmax_agree, weights, params: N, L, hamming
    weight, security; `info` gives the params, default the compiled
    scheme) plus `card`, `max_memory_allocated` and `stats`;
    on_row(rows) after every image."""
    import torch
    from ace_tpu_torch.compiler.scheme_info import security_posture
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.utils.card import card

    model = M.compile_model(graph, cfg, ctx=ctx, num_classes=classes,
                            trace=trace)
    info = info or model.scheme
    sec = security_posture(info)
    gpu = ctx.device.type == "cuda"
    name_power = card() if gpu else None
    rows = []
    for i, img in enumerate(images):
        plain = M.infer_plain(graph, img)[:classes]
        t0 = time.time()
        logits, stats = measured_infer(model, img)
        dt = time.time() - t0
        logits = logits[:classes]
        top = np.sort(plain)[::-1]
        stats = dict(stats, argmax=int(np.argmax(logits)),
                     plain_argmax=int(np.argmax(plain)),
                     max_plain=float(np.max(np.abs(plain))),
                     plain_margin=float(top[0] - top[1]),
                     logits=[float(x) for x in logits],
                     plain_logits=[float(x) for x in plain])
        rows.append(dict(
            image=i, seconds=dt,
            max_err=float(np.max(np.abs(logits - plain))),
            argmax_agree=bool(np.argmax(logits) == np.argmax(plain)),
            weights=weights_of(name),
            params=dict(N=info.poly_degree, L=info.mul_level,
                        hamming_weight=info.hamming_weight,
                        security=sec["detail"]),
            card=name_power,
            max_memory_allocated=(torch.cuda.max_memory_allocated()
                                  if gpu else None),
            stats=stats))
        if on_row:
            on_row(rows)
    return rows


def gate_failures(row, classes: int, bootstraps: int, max_err=None,
                  kernels: bool = True) -> list:
    """The gates `row` fails: finite logits of shape (classes,),
    `bootstraps` bootstraps, max_err <= `max_err` where given, and with
    `kernels` every kernel launched. Empty when it holds them all."""
    st = row["stats"]
    logits = np.asarray(st["logits"])
    fails = []
    if not (logits.shape == (classes,) and np.all(np.isfinite(logits))):
        fails.append(f"logits of shape {logits.shape} not finite or not "
                     f"({classes},)")
    if st["bootstraps"] != bootstraps:
        fails.append(f"{st['bootstraps']} bootstraps, expected {bootstraps}")
    if max_err is not None and not row["max_err"] <= max_err:
        fails.append(f"max_err {row['max_err']} > {max_err}")
    idle = [k for k, n in st["launches"].items() if n == 0]
    if kernels and idle:
        fails.append(f"kernels never launched: {idle}")
    return fails


def gates_for(name: str, graph, device) -> dict:
    """gate_failures' bounds for a zoo model: one bootstrap before each
    ReLU, MAX_ERR[name] where it has one, and the launch gate on the
    card (on the CPU the kernels' plain versions run)."""
    import torch
    return dict(bootstraps=sum(op.op_type == "Relu" for op in graph.ops),
                max_err=MAX_ERR.get(name),
                kernels=torch.device(device or "cuda").type == "cuda")


def write_json(path: str, obj, indent=None) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=indent)
    os.replace(path + ".tmp", path)


def main(argv=None):
    args = parse_args(argv)
    from ace_tpu_torch.compiler.scheme_info import select_params
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.timing import TIMING

    TIMING.enabled = True
    names = [n for n in args.models.split(",") if n]

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"# device={args.device or 'cuda'} models={names}")
    kw = dict(relu_depth=args.relu_depth, relu_range=args.relu_range)
    infos = {name: select_params(M.load_model(name), cfg_for(name, **kw))
             for name in names}
    t0 = time.time()
    shared, ctx = shared_context(infos, args.max_rot_keys,
                                 device=args.device)
    log(f"# shared context N=2^{shared.poly_degree.bit_length() - 1} "
        f"L={shared.mul_level}, {ctx.keygen.max_rot_keys} rotation keys "
        f"in the LRU ({time.time() - t0:.0f}s)")
    os.makedirs(args.out_dir, exist_ok=True)
    imgs = zoo_images(args.images)
    failed = []
    for name in names:
        g = M.load_model(name)
        cfg = cfg_for(name, g, imgs, **kw)

        def flush(rows, _name=name):
            row = rows[-1]
            print(f"{_name} image {row['image']}: {row['seconds']:.1f}s "
                  f"err={row['max_err']:.3e} agree={row['argmax_agree']}",
                  flush=True)
            write_json(os.path.join(args.out_dir, f"torch_{_name}.json"),
                       rows)

        rows = run_model(name, g, cfg, ctx, imgs, classes_of(name),
                         info=infos[name],
                         trace=lambda m, _n=name: log(f"# [{_n}] {m}"),
                         on_row=flush)
        gates = gates_for(name, g, args.device)
        fails = [f"{name} image {r['image']}: {f}" for r in rows
                 for f in gate_failures(r, classes_of(name), **gates)]
        failed += fails
        write_json(os.path.join(args.out_dir, f"torch_accuracy_{name}.json"),
                   dict(model=name, images=args.images,
                        agree=sum(r["argmax_agree"] for r in rows),
                        max_err=max(r["max_err"] for r in rows),
                        per_image=rows, synthetic=True,
                        relu_depth=args.relu_depth,
                        relu_range=args.relu_range, gates=gates,
                        gates_failed=fails, card=rows[-1]["card"],
                        max_memory_allocated=rows[-1][
                            "max_memory_allocated"]), indent=1)
    log(TIMING.report())
    if failed:
        raise SystemExit("gates failed:\n" + "\n".join(failed))


if __name__ == "__main__":
    main()
