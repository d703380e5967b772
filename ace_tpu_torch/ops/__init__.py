def kernel_wrappers() -> dict:
    """The wrappers of the four CUDA kernels by name: K1 (Barrett
    product), K2 (Shoup product), K3 and K4 (forward and inverse NTT).
    Each counts in `launches` the calls that launched its kernel, never
    one that ran the plain version on the CPU; K3 and K4 also count the
    limbs they transformed in `limbs`."""
    from ace_tpu_torch.ops import ntt4, pallas_modops as pm
    return {"K1": pm.barrett_mul, "K2": pm.shoup_mul, "K3": ntt4.ntt4_fwd,
            "K4": ntt4.ntt4_inv}
