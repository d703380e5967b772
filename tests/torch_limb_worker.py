"""Rank functions of the limb-mesh tests (tests/test_torch_limb_mesh.py,
tests/test_torch_multichip_eval.py). The ranks are spawned processes that
import this module by name, so it imports torch and the port only, never
jax: the tests compute ace_tpu's side in the parent and pass numpy arrays
in and out."""

import numpy as np
import torch

from ace_tpu_torch import interop
from ace_tpu_torch.ckks.encoder import Encoder
from ace_tpu_torch.ckks.evaluator import Evaluator
from ace_tpu_torch.ckks.keygen import switch_key_nbytes
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops
from ace_tpu_torch.parallel.mesh import (make_mesh, put_limb, replicated,
                                         shard_poly)
from ace_tpu_torch.runtime.context import FheContext

CPU = torch.device("cpu")


def gathered(crt, ct) -> tuple:
    """Both components of ct, every limb, in global order (numpy)."""
    return tuple(modops.to_numpy(crt.gather_poly(p)) for p in (ct.c0, ct.c1))


def _port(mesh, case):
    """Params sharded over `mesh`, the case's injected ace_tpu keys and
    an Evaluator on them."""
    params = CkksParams(**case["params"], device="cpu")
    params.crt.shard(mesh)
    kg = interop.keygen(params, *case["keys"])
    enc = Encoder(params)
    return params, kg, enc, Evaluator(params, kg, enc)


def _ct(params, arrays, meta, num_p=0):
    return interop.ciphertext(*arrays, *meta, CPU, num_p=num_p,
                              crt=params.crt)


# ---------------------------------------------------------------------------
# tests/test_torch_limb_mesh.py
# ---------------------------------------------------------------------------

def layouts(mesh, shapes, data):
    """For each (n_dp, n_limb) of `shapes`, a mesh over the world (the
    first is the world's own): the rank's coordinates, its groups, and
    what put_limb, shard_poly and replicated give it of `data` [L, N]
    and of a batch [n_dp, L, N] of it, with the local prefix of every
    level."""
    out = []
    for n_dp, n_limb in shapes:
        m = mesh if (n_dp, n_limb) == (mesh.n_dp, mesh.n_limb) \
            else make_mesh(n_dp, n_limb, "gloo", CPU)
        t = torch.as_tensor(data)
        batch = torch.stack([t + i for i in range(n_dp)])
        params = CkksParams(degree=data.shape[1], num_q=data.shape[0] - 1,
                            first_mod_size=60, scaling_mod_size=56,
                            num_q_parts=2, device="cpu")
        crt = params.crt
        crt.shard(m)
        out.append({
            "rank": m.rank, "dp": m.dp, "limb": m.limb, "shape": m.shape,
            "groups": m.group_ranks(),
            "put": put_limb(t, m).numpy(),
            "shard": shard_poly(m, data),
            "batched": shard_poly(m, batch, batched=True).numpy(),
            "replicated": replicated(m)(data),
            "prefix": [crt.q_rows(lv) for lv in range(data.shape[0] + 1)],
            "put_prefix": [put_limb(t[:lv], m).numpy()
                           for lv in range(data.shape[0] + 1)],
        })
    return out


def own_context_keys(mesh, kw, seed):
    """FheContext(mesh=...) with its own keys: the rank's resident bytes
    of the relinearization key, its rows of it gathered to every limb,
    and switch_key_nbytes."""
    ctx = FheContext(CkksParams(**kw, device="cpu"), seed=seed, mesh=mesh)
    crt = ctx.params.crt
    key = ctx.keygen.relin_key
    sk = ctx.keygen.sk.ntt_sk
    return {"rows": key.b[0].data.shape[0], "resident": key.nbytes,
            "total": switch_key_nbytes(ctx.params),
            "key_memory": ctx.key_memory_bytes(),
            "relin_b": [modops.to_numpy(crt.gather_poly(p)) for p in key.b],
            "relin_a": [modops.to_numpy(crt.gather_poly(p)) for p in key.a],
            "sk": modops.to_numpy(crt.gather_poly(sk)),
            "pk_b": modops.to_numpy(crt.gather_poly(ctx.keygen.pk.b))}


def own_context_roundtrip(mesh, kw, seed, msg):
    """prepare_input, rotate and handle_output through FheContext(mesh=)
    with the context's own keys: the decoded values on every rank."""
    ctx = FheContext(CkksParams(**kw, device="cpu"), seed=seed, mesh=mesh)
    ct = ctx.prepare_input(msg, "x")
    ctx.set_output_data("y", ctx.evaluator.rotate(ct, 1))
    return ctx.handle_output("y", len(msg))


def refuses_checkpoint(mesh, kw, path):
    """A compiled model's run with a checkpoint under a limb mesh raises."""
    from ace_tpu_torch.compiler.lowering import GraphRunner
    from ace_tpu_torch.compiler.packing import FheBackend
    ctx = FheContext(CkksParams(**kw, device="cpu"), seed=1, mesh=mesh)
    be = FheBackend(ctx.evaluator, ctx.encoder)
    low = GraphRunner.__new__(GraphRunner)
    low.be = be
    try:
        low.run(None, checkpoint=path)
    except NotImplementedError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# tests/test_torch_multichip_eval.py
# ---------------------------------------------------------------------------

def rotate_mul_rescale(mesh, case):
    """tests/test_multichip_eval.py's first case on injected keys and
    ciphertext: rotate by 3, mul + relinearize, rescale; gathered
    residues and the decoded values."""
    params, kg, enc, ev = _port(mesh, case)
    ct = _ct(params, case["ct"], case["meta"])
    r = ev.rotate(ct, 3)
    sq = ev.mul(r, r)
    rs = ev.rescale(sq)
    crt = params.crt
    dec = enc.decode(ev.decrypt(rs), case["n"]).real
    return {"rotate": gathered(crt, r), "mul": gathered(crt, sq),
            "rescale": gathered(crt, rs), "decoded": dec,
            "rows": [rs.c0.data.shape[0], sq.c0.data.shape[0]],
            "stats": mesh.stats()}


def off_path_ops(mesh, case):
    """The evaluator's other methods on the first case's ciphertext:
    each result gathered."""
    params, kg, enc, ev = _port(mesh, case)
    ct = _ct(params, case["ct"], case["meta"])
    msgs = torch.stack([enc.encode_msg(v) for v in case["msg_values"]])
    out = {"mul_by_monomial": ev.mul_by_monomial(ct, 7),
           "add_const": ev.add_const(ct, 0.25),
           "mul_integer": ev.mul_integer(ct, 3),
           "mod_switch": ev.mod_switch(ct),
           "conjugate": ev.conjugate(ct),
           "rot_sum": ev.rot_sum_jit([(ct, 1), (ct, 2)]),
           "rotate_ext": ev.mod_down_ciph(ev.rotate_ext(ct, 1)),
           "msgs": ev.rot_mac_groups_msgs_jit(ct, [1, 2], msgs[None])[0]}
    for i, c in enumerate(ev.rotations_hoisted(ct, [1, 2])):
        out[f"hoisted{i}"] = c
    return {k: gathered(params.crt, v) for k, v in out.items()}


def mac_groups(mesh, case):
    """The second case: FheBackend.rot_ext_mac_groups(ct, [1, 2, 5],
    [[w, w, None]]) and its decode."""
    from ace_tpu_torch.compiler.packing import FheBackend
    params, kg, enc, ev = _port(mesh, case)
    ct = _ct(params, case["ct"], case["meta"])
    be = FheBackend(ev, enc)
    w = np.ones(case["n"])
    out = be._norm(be.rot_ext_mac_groups(ct, [1, 2, 5], [[w, w, None]])[0])
    return {"out": gathered(params.crt, out),
            "decoded": enc.decode(ev.decrypt(out), case["n"]).real}


def bootstrap(mesh, case):
    """The third case: rescale(mul_const(ct, 1.0)), then a bootstrap."""
    from ace_tpu_torch.ckks.bootstrap import BootstrapContext
    params, kg, enc, ev = _port(mesh, case)
    ct = _ct(params, case["ct"], case["meta"])
    ct = ev.rescale(ev.mul_const(ct, 1.0))
    out = BootstrapContext(ev, ct.slots).bootstrap(ct)
    return {"out": gathered(params.crt, out), "level": out.level,
            "decoded": enc.decode(ev.decrypt(out), case["n"]).real}


def dryrun_step(mesh, case):
    """The dry run's dp x limb step (__graft_entry__.dryrun_multichip):
    each dp row takes its ciphertext of the batch (put_limb batched) and
    computes rescale(mul_plain(add(rotate(c, 1), c), w))."""
    params, kg, enc, ev = _port(mesh, case)
    crt = params.crt
    rows = crt.limbs(case["level"], 0)
    c0, c1 = (put_limb(torch.as_tensor(np.asarray(b).view(np.int64)), mesh,
                       rows, batched=True)[0] for b in case["batch"])
    from ace_tpu_torch.ckks.cipher import Ciphertext
    from ace_tpu_torch.poly.poly import RnsPoly
    ct = Ciphertext(RnsPoly(c0, case["level"], 0, True),
                    RnsPoly(c1, case["level"], 0, True), *case["meta"])
    w = enc.encode(np.full(case["n"], 0.5, np.complex128), level=ct.level)
    out = ev.rescale(ev.mul_plain(ev.add(ev.rotate(ct, 1), ct), w))
    return {"dp": mesh.dp, "out": gathered(crt, out)}


def on_mesh(mesh, shape, name, *args):
    """Function `name` of this module on an (n_dp, n_limb) mesh made over
    the world (the world's own mesh when the shape is its)."""
    m = mesh if tuple(shape) == (mesh.n_dp, mesh.n_limb) \
        else make_mesh(*shape, "gloo", CPU)
    return globals()[name](m, *args)


def jobs(mesh, calls):
    """Run several of the functions above in one world: calls is a list
    of (function name, args); returns their results in order."""
    return [globals()[name](mesh, *args) for name, args in calls]
