"""The digit x slot SPMD key switch of `ace_tpu.parallel` on
torch.distributed: `mesh` (process groups, collectives, the launcher),
`sharded_ntt` (the slot-sharded 4-step NTT), `spmd` (SpmdKeySwitch) and
`spmd_eval` (SpmdEvaluator, behind FheContext(digit_mesh=...))."""
