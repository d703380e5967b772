def kernel_wrappers() -> dict:
    """The wrappers of the six CUDA kernels by name: K1 (Barrett
    product), K2 (Shoup product), K3 and K4 (forward and inverse NTT),
    K5 (fast base conversion), K6 (the plaintext-message lift).
    Each counts in `launches` the calls that launched its kernel, never
    one that ran the plain version on the CPU; K3 and K4 also count the
    limbs they transformed in `limbs`. A replayed op program
    (utils/liftgraph.py) adds the launches its graph holds."""
    from ace_tpu_torch.ops import baseconv, lift, ntt4, pallas_modops as pm
    return {"K1": pm.barrett_mul, "K2": pm.shoup_mul, "K3": ntt4.ntt4_fwd,
            "K4": ntt4.ntt4_inv, "K5": baseconv.base_conv,
            "K6": lift.lift_msgs}


def reset_counters() -> None:
    """Every wrapper's `launches` (and the NTT wrappers' `limbs`) to 0."""
    for w in kernel_wrappers().values():
        w.launches = 0
        if hasattr(w, "limbs"):
            w.limbs = 0


def read_counters() -> dict:
    """Each kernel's launches since the last reset_counters."""
    return {k: w.launches for k, w in kernel_wrappers().items()}


def read_limbs() -> dict:
    """Limbs transformed by the NTT kernels' launches."""
    return {k: w.limbs for k, w in kernel_wrappers().items()
            if hasattr(w, "limbs")}


def counter_state() -> dict:
    """Every counter of every wrapper: {(name, "launches" or "limbs"): n}."""
    return {(k, a): getattr(w, a) for k, w in kernel_wrappers().items()
            for a in ("launches", "limbs") if hasattr(w, a)}


def counter_delta(before: dict) -> dict:
    """The counters' growth since `before` (a counter_state)."""
    return {k: v - before[k] for k, v in counter_state().items()}


def add_counters(delta: dict) -> None:
    """Add `delta` (a counter_delta) to the counters: the launches of a
    captured graph's replay, which runs no wrapper
    (utils/liftgraph.py)."""
    wrappers = kernel_wrappers()
    for (k, a), n in delta.items():
        setattr(wrappers[k], a, getattr(wrappers[k], a) + n)


def restore_counters(state: dict) -> None:
    """Set the counters back to `state` (a counter_state)."""
    wrappers = kernel_wrappers()
    for (k, a), n in state.items():
        setattr(wrappers[k], a, n)
