"""Readings that the limits of limits/<cell>.json are set from: the
program's logit gap on many seeds, and the controls' on the same images.

    python3 fhebench/control.py --workload <cell> --seeds S1,S2,...
        [--program-control KEY=VALUE[,KEY=VALUE] ...] [--control-seeds 3]
        [--out readings.json]

One process, one set-up: the program compiled as the cell's run
compiles it, warmed up on the first seed's warm-up images, then for each
seed the image that a run of that seed sends first in its window (its
warm-up images are the first seed's only). Each image is compared with
the float64 reference. The controls, each on the same images:
- the reference computed in float32, bfloat16 and float8 (e4m3) in the
  program's place;
- each --program-control: the program itself with those keys of the
  configuration's scheme changed (a lower-precision path of its own,
  e.g. first_mod_size=59), compiled anew after the previous program's
  state is freed, on the first --control-seeds seeds.
Prints one JSON object and writes it to --out. Needs the card, as a run
does; tests call `readings` on the CPU.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness's modules are imported as fhebench.*, never by their bare
# names from the script's own directory
sys.path = [ROOT] + [p for p in sys.path
                     if os.path.abspath(p or ".") not in (HERE, ROOT)]

LOWER_PRECISIONS = ("float32", "bfloat16", "float8_e4m3")


def _scheme(base: dict, changes: str) -> dict:
    out = dict(base)
    for kv in changes.split(","):
        k, v = kv.split("=", 1)
        if k not in out:
            raise KeyError(f"no scheme key {k!r}")
        out[k] = type(out[k])(json.loads(v))
    return out


def _window_images(cell, seed: int, device, warm: bool):
    """The images a run of `seed` sends: its warm-up images (if `warm`)
    and the first of its window."""
    from fhebench import run
    draw = run.images_of(cell, seed, device)
    imgs = [draw() for _ in range(cell.traffic["warmup_images"] + 1)]
    return imgs if warm else imgs[-1:]


def readings(cell, seeds: list, device, program_control: list = (),
             control_seeds: int = 3, log=print) -> dict:
    """The program's gap per seed and each control's, as set out in the
    module docstring."""
    import numpy as np
    import torch
    from fhebench import check, reference, run

    outputs = cell.config["architecture"]["classes"]
    t = time.perf_counter()
    net, weights, prog = run.setup(cell, device)
    log(f"# set-up {time.perf_counter() - t:.1f} s")
    out = {"seeds": list(seeds), "program": [],
           "reference": {p: [] for p in LOWER_PRECISIONS}}
    for i, seed in enumerate(seeds):
        imgs = _window_images(cell, seed, device, warm=(i == 0))
        t = time.perf_counter()
        got = [prog.infer(im.cpu().numpy()) for im in imgs]
        dt = time.perf_counter() - t
        batch = torch.stack(imgs)
        ref = reference.forward(net, weights, batch, outputs).cpu().numpy()
        g = check.gaps(np.stack(got), ref)
        out["program"].append(g[-1])
        if i == 0:
            out["warmup"] = g[:-1]
        for p in LOWER_PRECISIONS:
            low = reference.forward(net, weights, batch, outputs,
                                    p).cpu().numpy()
            out["reference"][p].append(check.gaps(low[-1:], ref[-1:])[0])
        log(f"# seed {seed}: program gap {g[-1]:.6g} ({len(imgs)} images, "
            f"{dt:.1f} s); reference "
            + ", ".join(f"{p} {out['reference'][p][-1]:.6g}"
                        for p in LOWER_PRECISIONS))
    prog.close()
    del prog
    gc.collect()
    out["program_control"] = {}
    for key in program_control:
        scheme = _scheme(cell.config["scheme"], key)
        gaps = out["program_control"][key] = []
        t = time.perf_counter()
        _, _, ctl = run.setup(cell, device, scheme)
        log(f"# control {key}: set-up {time.perf_counter() - t:.1f} s, "
            f"ring {ctl.ring()}")
        for i, seed in enumerate(seeds[:control_seeds]):
            imgs = _window_images(cell, seed, device, warm=(i == 0))
            got = np.stack([ctl.infer(im.cpu().numpy()) for im in imgs])
            ref = reference.forward(net, weights, torch.stack(imgs),
                                    outputs).cpu().numpy()
            g = check.gaps(got, ref)
            gaps.append(g[-1])
            log(f"# control {key} seed {seed}: gap {g[-1]:.6g}")
        ctl.close()
        del ctl
        gc.collect()
    out["lower"] = max(out["program"] + out["warmup"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--program-control", action="append", default=[],
                    help="KEY=VALUE[,KEY=VALUE] of the scheme: one of the "
                         "program's own lower-precision controls "
                         "(repeatable)")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from fhebench import cells
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("fhebench.control: needs a CUDA card", file=sys.stderr)
        return 2
    res = readings(cell, [int(s) for s in args.seeds.split(",")], "cuda",
                   args.program_control, args.control_seeds,
                   log=lambda m: print(m, file=sys.stderr, flush=True))
    res["card"] = torch.cuda.get_device_name()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
