"""The multi-device half of `ace_tpu.parallel` on torch.distributed:
`mesh` (the two-axis process meshes, their collectives and launcher;
make_mesh / put_limb and the limb shard's placement, behind
FheContext(mesh=...) and CrtContext.shard), and the digit x slot SPMD
key switch: `sharded_ntt` (the slot-sharded 4-step NTT), `spmd`
(SpmdKeySwitch) and `spmd_eval` (SpmdEvaluator, behind
FheContext(digit_mesh=...))."""
