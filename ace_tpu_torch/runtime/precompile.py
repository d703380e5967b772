"""Op-program inventory and preparation ahead of a run.

The counterpart of `ace_tpu.runtime.precompile`. There, every evaluator
op bundle is a jitted XLA program that pays a compile the first time it
is seen; the inventory lists a model's programs and worker processes
compile them into JAX's persistent cache before the run. Here an op
program is a CUDA graph (utils/liftgraph.py) captured at its second
call:

  1. *Inventory* (`patch_inventory`, `inventory`, the `inventory`
     command): run the model once with an evaluator whose programs are
     stubs that record each program's cache key and argument shapes and
     count its calls, and return zeros of its output shapes without
     running it; the encoder and the rotation keys are stubbed too
     (zeros of the right shapes). The CKKS level trajectory does not
     depend on the data, so the inventory is exact. It runs on the card
     unless --device cpu is given (the ops outside programs still run:
     adds, level drops, the keys' shapes); its JSONL has ace_tpu's
     schema (the dtype reads int64 where ace_tpu has uint64, the port's
     residue storage).
  2. *Preparation* (`prepare`): a CUDA graph cannot be saved for
     another process, so ace_tpu's worker half (run_worker, which
     compiled the programs in other processes) becomes an in-process
     pass: it makes the keys the records name and runs each recorded
     program twice on zeros of its shapes, its warm-up and its capture,
     so that image 0 already replays every program. The keys are then
     drawn in the inventory's order, not the run's, so a prepared
     run's residues differ from an unprepared one's (both decrypt to
     the same values). ace_tpu's executable sharing between programs
     of one shape (_dedup_key) has no counterpart: every graph is its
     own.

Usage:
  python -m ace_tpu_torch.runtime.precompile inventory \\
      --out inv.jsonl [--model NAME] [--relu-depth 9] [--device DEV]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# program kind -> Evaluator builder (ace_tpu's _BUILDERS and the two
# message bundles)
_BUILDERS = {
    "addc": "_mk_add_scalar",
    "mp": "_mk_mul_plain",
    "mulrl": "_mk_mul_relin",
    "rs": "_mk_rescale",
    "rot": "_mk_rotate",
    "rsum": "_mk_rot_sum",
    "rmg": "_mk_rot_mac_groups",
    "rmgm": "_mk_rot_mac_groups_msgs",
    "bsgs": "_mk_bsgs_iter",
}


# position of a program's first key-plane argument (the planes are read
# by reference: Evaluator._key_raw)
_KEY_ARGS = {"rot": 2, "mulrl": 4, "rsum": 1, "rmg": 2, "rmgm": 2,
             "bsgs": 2}


# -- (de)serialization of builder args and call args -------------------------

def _ser_shapes(x):
    """Nested lists/tuples of tensors -> nested lists of {s, d}."""
    if isinstance(x, (list, tuple)):
        return [_ser_shapes(v) for v in x]
    return {"s": list(x.shape), "d": str(x.dtype).replace("torch.", "")}


def _ser_key(key):
    """Builder args (nested tuples of int/bool) -> JSON."""
    if isinstance(key, tuple):
        return [_ser_key(k) for k in key]
    return key


def _detuple(x):
    """JSON lists back to tuples (builder args and program keys)."""
    if isinstance(x, list):
        return tuple(_detuple(v) for v in x)
    return x


def _zeros(shapes, device):
    """Zero tensors of serialized shapes (nested lists of {s, d})."""
    if isinstance(shapes, list):
        return [_zeros(s, device) for s in shapes]
    return torch.zeros(shapes["s"], dtype=getattr(torch, shapes["d"]),
                       device=device)


def _out_zeros(key, args):
    """Zeros of a program's outputs: every program maps a ciphertext at
    its level to ciphertexts at the same level (one pair per group for
    rmg and rmgm, c0 alone for addc), except rs, one level down."""
    kind = key[0]
    c0, c1 = args[0][0] if kind == "rsum" else (args[0], args[1])
    z = torch.zeros_like
    if kind == "addc":
        return z(c0)
    if kind == "rs":
        return z(c0[:-1]), z(c1[:-1])
    if kind in ("rmg", "rmgm"):
        groups = len(key[2]) if kind == "rmg" else key[2]
        return [(z(c0), z(c1)) for _ in range(groups)]
    return z(c0), z(c1)


def program_key(record: dict) -> tuple:
    """The evaluator's cache key of an inventory record: (kind, *builder
    args), with the group count G inserted for rmgm."""
    kind, bargs = record["kind"], _detuple(record["builder_args"])
    if kind == "rmgm":
        return ("rmgm", bargs[0], record["arg_shapes"][4]["s"][0], bargs[1])
    return (kind, *bargs)


# -- inventory ---------------------------------------------------------------

def patch_inventory(ev, records: list) -> None:
    """Replace ev's program dispatch with record-shapes-only stubs.

    Each record carries a "calls" count (how many times the program is
    called per image), updated in place as the stubs run; a stub returns
    zeros of its program's output shapes and runs nothing."""
    stubs = {}

    def get_jit(key, builder, *builder_args):
        if key not in stubs:
            state = {}

            def stub(*args, _key=key, _bargs=builder_args, _state=state):
                if "rec" not in _state:
                    _state["rec"] = {
                        "kind": _key[0],
                        "builder_args": _ser_key(tuple(_bargs)),
                        "arg_shapes": _ser_shapes(list(args)),
                        "calls": 0,
                    }
                    records.append(_state["rec"])
                _state["rec"]["calls"] += 1
                return _out_zeros(_key, args)

            stubs[key] = stub
        return stubs[key]

    ev._get_jit = get_jit


def patch_encoder(enc) -> None:
    """Replace encode() and encode_msg() with zero stubs of the same
    structure: program keys depend on shapes, levels and the host-side
    mask patterns (dead groups are pruned before encoding), never on
    encoded values, and the real encode pays an embedding per vector."""
    from ace_tpu_torch.ckks.encoder import Plaintext
    from ace_tpu_torch.poly.poly import RnsPoly

    params = enc.params
    crt = params.crt

    def stub_encode(values, level=0, slots=0, sf_degree=1, extended=False):
        level_ = level or crt.num_q
        num_p = crt.num_p if extended else 0
        rows = len(crt.local(crt.limbs(level_, num_p)))
        data = torch.zeros((rows, params.degree), dtype=torch.int64,
                           device=enc.device)
        return Plaintext(RnsPoly(data, level_, num_p, True),
                         params.scaling_factor ** sf_degree, sf_degree,
                         slots or params.degree // 2)

    def stub_encode_msg(values, slots=0):
        return enc.zero_msg()

    enc.encode = enc.encode_cached = stub_encode
    enc.encode_msg = stub_encode_msg


def patch_keygen(kg) -> None:
    """Make every rotation key a fresh SwitchKey over one shared set of
    zero digit planes: the inventory reads key shapes only, and a real
    key at full size costs seconds on the CPU."""
    from ace_tpu_torch.ckks.keygen import SwitchKey
    planes = None

    def stub_switching_key(new_key, old_key):
        nonlocal planes
        if planes is None:
            z = torch.zeros_like(old_key.data)
            planes = [z] * kg.params.num_q_parts
        return SwitchKey(list(planes), list(planes))

    kg._gen_switching_key = stub_switching_key


def inventory(graph, cfg, image, num_classes: int = 10, device=None,
              trace=None) -> tuple:
    """(header, records): the op programs of one encrypted inference of
    `graph` under `cfg` on `image`, with their per-image calls. device:
    None runs on the card (and raises without one), as FheContext."""
    from ace_tpu_torch.compiler.scheme_info import select_params
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.context import FheContext

    info = select_params(graph, cfg)
    ctx = FheContext(scheme_info=info, max_rot_keys=100, device=device)
    patch_encoder(ctx.encoder)
    patch_keygen(ctx.keygen)
    model = M.compile_model(graph, cfg, ctx=ctx, num_classes=num_classes,
                            trace=trace)
    records: list = []
    patch_inventory(model.ctx.evaluator, records)
    M.infer_encrypted(model, image)
    scheme = model.scheme
    header = {
        "kind": "header", "degree": scheme.poly_degree,
        "num_q": scheme.mul_level + 1,
        "first_mod_size": scheme.first_mod_size,
        "scaling_mod_size": scheme.scaling_mod_size,
        "hamming_weight": scheme.hamming_weight,
        "num_q_parts": scheme.q_part_num,
    }
    return header, records


def run_inventory(args) -> list:
    """The `inventory` command: ace_tpu's run_inventory on the port (the
    model built natively when --model is not given, as
    run_resnet_torch.py does). Writes the header and one line per
    program to args.out and returns the records."""
    import numpy as np
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import SchemeConfig
    from ace_tpu_torch.models import resnet as M

    name = args.model or "resnet20_cifar10"
    g = M.load_model(args.model) if args.model else M.build_resnet_cifar(3)
    vr_default, vr = ranges_for(name)
    if args.relu_range:
        vr_default, vr = args.relu_range, {}
    cfg = SchemeConfig(security_level=0,
                       hamming_weight=args.hamming_weight,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=args.relu_depth,
                       relu_value_range=vr_default, relu_ranges=vr,
                       use_bootstrap=any(op.op_type == "Relu"
                                         for op in g.ops))
    t0 = time.time()
    img = np.random.default_rng(0).uniform(-1.5, 1.5, (3, 32, 32))
    header, records = inventory(
        g, cfg, img, num_classes=100 if "cifar100" in name else 10,
        device=args.device,
        trace=lambda m: print(f"# {m}", file=sys.stderr, flush=True))
    with open(args.out, "w") as f:
        f.write(json.dumps(dict(header, model=name)) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    print(f"inventory: {len(records)} unique programs, "
          f"{sum(r['calls'] for r in records)} calls an image, in "
          f"{time.time() - t0:.1f}s -> {args.out}")
    return records


# -- preparation -------------------------------------------------------------

def _program_args(ev, record: dict) -> tuple:
    """(the arguments of a recorded program, the switching keys among
    them): zeros of the recorded shapes for the data, the keygen's keys
    for the key planes (rotation keys by automorphism index, made if
    absent; the relinearization key for mulrl)."""
    kind = record["kind"]
    bargs = _detuple(record["builder_args"])
    kg = ev.keygen

    def rot_keys(auto_idxs):
        return [kg._auto_key(ai)[1] for ai in auto_idxs if ai != 1]

    if kind == "rot":
        keys = [rot_keys(bargs[:1])]
    elif kind == "mulrl":
        keys = [[kg.relin_key]]
    elif kind == "bsgs":
        keys = [rot_keys(bargs[0]), rot_keys(bargs[1])]
    elif kind in ("rsum", "rmg", "rmgm"):
        keys = [rot_keys(bargs[0])]
    else:
        keys = []
    at = _KEY_ARGS.get(kind, 0)
    shapes = record["arg_shapes"]
    planes = [p for ks in keys for p in (
        ev._key_raw(ks[0]) if kind in ("rot", "mulrl")
        else ev._raw_planes(ks))]
    args = (_zeros(shapes[:at], ev.crt.device) + planes
            + _zeros(shapes[at + len(planes):], ev.crt.device))
    return args, [k for ks in keys for k in ks]


def prepare(ctx, records) -> dict:
    """Make the keys `records` (an inventory, header lines skipped) name
    and run each recorded program of ctx's evaluator twice on zeros of
    its shapes: its warm-up (call 1) and its capture (call 2), so that
    the first image replays every program. In-process: a CUDA graph
    cannot be saved for another process, so this replaces ace_tpu's
    run_worker (ace_tpu/runtime/precompile.py:234). Returns the count of
    programs and the seconds taken."""
    ev = ctx.evaluator
    t0 = time.perf_counter()
    n = 0
    for r in records:
        if r["kind"] == "header":
            continue
        key = program_key(r)
        bargs = _detuple(r["builder_args"])
        builder = getattr(ev, _BUILDERS[r["kind"]])
        for _ in range(2):
            args, keys = _program_args(ev, r)
            ev._run(key, ev._get_jit(key, builder, *bargs), keys, *args)
        n += 1
    return {"programs": n, "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    inv = sub.add_parser("inventory")
    inv.add_argument("--model", default="",
                     help="a load_model name (default: ResNet-20 built "
                          "natively, as resnet20_cifar10)")
    inv.add_argument("--out", required=True)
    inv.add_argument("--hamming-weight", type=int, default=192)
    inv.add_argument("--relu-depth", type=int, default=9)
    inv.add_argument("--relu-range", type=float, default=0.0)
    inv.add_argument("--device", default=None,
                     help="torch device (default: the card; cpu runs the "
                          "plain versions)")
    run_inventory(ap.parse_args(argv))


if __name__ == "__main__":
    main()
