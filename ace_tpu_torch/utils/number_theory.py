"""Host-side exact number theory for CKKS parameter construction.

Pure-Python big integers (no GMP needed). Semantics replicate the
reference runtime so that generated moduli chains and root-of-unity
tables are bit-identical:

  - prime search:      fhe-cmplr/rtlib/ant/src/util/crt.c:16-124
  - generator search:  fhe-cmplr/rtlib/ant/src/util/number_theory.c:92-135
  - root of unity:     fhe-cmplr/rtlib/ant/src/util/number_theory.c:139-157
  - automorphism idx:  fhe-cmplr/rtlib/ant/src/util/number_theory.c:187-200
  - cached ROU table:  fhe-cmplr/rtlib/ant/src/util/fhe_std_parms.c:200-270
"""

from __future__ import annotations

import functools
import math


# ---------------------------------------------------------------------------
# Primality (deterministic Miller-Rabin, exact for < 2^64 — the reference
# uses a randomized 200-trial Miller-Rabin; primality itself is a fact, so
# the selected prime chains are identical).
# ---------------------------------------------------------------------------

_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


# ---------------------------------------------------------------------------
# Prime chain search (candidates are always ≡ 1 mod 2N).
# ---------------------------------------------------------------------------

def gen_first_prime(ring_degree: int, mod_size: int) -> int:
    """First prime above 2^mod_size that is ≡ 1 (mod 2N).

    Reference: crt.c:16-24 (Gen_first_prime).
    """
    assert mod_size <= 64
    order = 2 * ring_degree
    cand = (1 << mod_size) + order + 1
    while not is_prime(cand):
        cand += order
    return cand


def gen_previous_prime(mod: int, order: int) -> int:
    cand = mod - order
    while not is_prime(cand):
        cand -= order
    return cand


def gen_next_prime(mod: int, order: int) -> int:
    # The reference's do-while adds `order` AGAIN before the first
    # primality test (crt.c:34-41), so mod + order is never considered.
    # Replicated exactly: at small rings (order 128) the skip changes
    # the chain — caught by the degree-64 bootstrap refvec fixture.
    cand = mod + 2 * order
    while not is_prime(cand):
        cand += order
    return cand


def generate_q_primes(num_primes: int, first_mod_size: int,
                      scaling_mod_size: int, ring_degree: int) -> list[int]:
    """The Q modulus chain, index 0 = first prime (q0), rest scaling primes.

    Exactly reproduces the alternating previous/next search of
    crt.c:89-126 (Generate_q_primes): primes array is filled from the
    last index downward, alternating below/above the anchor prime.
    """
    order = 2 * ring_degree
    primes = [0] * num_primes
    anchor = gen_first_prime(ring_degree, scaling_mod_size)
    primes[num_primes - 1] = anchor
    q_next = anchor
    q_prev = anchor
    if num_primes > 1:
        cnt = 0
        for i in range(num_primes - 2, 0, -1):
            if cnt % 2 == 0:
                q_prev = gen_previous_prime(q_prev, order)
                primes[i] = q_prev
            else:
                q_next = gen_next_prime(q_next, order)
                primes[i] = q_next
            cnt += 1
    if first_mod_size == scaling_mod_size:
        primes[0] = gen_previous_prime(q_prev, order)
    else:
        first_p = gen_first_prime(ring_degree, first_mod_size)
        primes[0] = gen_previous_prime(first_p, order)
    return primes


def generate_p_primes(num_primes: int, mod_size: int, ring_degree: int,
                      base_primes: list[int]) -> list[int]:
    """The P (key-switching extension) primes, descending from 2^mod_size,
    skipping collisions with the Q chain. Reference: crt.c:43-78.
    """
    order = 2 * ring_degree
    p_prev = gen_first_prime(ring_degree, mod_size)
    base = set(base_primes)
    primes = []
    for _ in range(num_primes):
        while True:
            cand = gen_previous_prime(p_prev, order)
            p_prev = cand
            if cand not in base:
                break
        primes.append(cand)
    return primes


# ---------------------------------------------------------------------------
# Generators and roots of unity
# ---------------------------------------------------------------------------

def _is_prime64(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (first 13 prime bases)."""
    if n < 2:
        return False
    bases = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
    for p in bases:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _pollard_rho(n: int) -> int:
    """A non-trivial factor of the odd composite n (Brent's variant)."""
    for c in range(1, n):
        y, m, g, r, q = 2, 128, 1, 1, 1
        x = ys = y
        while g == 1:
            x = y
            for _ in range(r):
                y = (y * y + c) % n
            k = 0
            while k < r and g == 1:
                ys = y
                for _ in range(min(m, r - k)):
                    y = (y * y + c) % n
                    q = q * abs(x - y) % n
                g = math.gcd(q, n)
                k += m
            r *= 2
        if g == n:
            g = 1
            while g == 1:
                ys = (ys * ys + c) % n
                g = math.gcd(abs(x - ys), n)
        if g != n:
            return g
    raise ValueError(f"no factor found for {n}")


def _prime_factors(n: int) -> list[int]:
    """Distinct prime factors of n, ascending: trial division by small
    numbers, then Pollard-Brent rho (the same set as plain trial
    division, which takes seconds per 60-bit prime at 2N = 2^16)."""
    factors = set()
    i = 2
    while i < 1000 and i * i <= n:
        if n % i == 0:
            factors.add(i)
            while n % i == 0:
                n //= i
        i += 1
    stack = [n] if n > 1 else []
    while stack:
        m = stack.pop()
        if m < 1000 * 1000 or _is_prime64(m):
            factors.add(m)
            continue
        d = _pollard_rho(m)
        stack.extend((d, m // d))
    return sorted(factors)


@functools.lru_cache(maxsize=None)
def find_generator(prime: int) -> int:
    """Smallest generator of (Z/pZ)*. Reference: number_theory.c:92-135."""
    phi = prime - 1
    factors = _prime_factors(phi)
    for r in range(2, phi + 1):
        if all(pow(r, phi // f, prime) != 1 for f in factors):
            return r
    raise ValueError(f"no generator found for {prime}")


# Cached (order, prime) -> primitive root of unity, matching the constants
# compiled into the reference (fhe_std_parms.c:200-270 "Rou[]" table).
# These entries take precedence over the generator search in the reference
# (number_theory.c:143-146), so they must take precedence here too.
_ROU_TABLE = {
    (32, 1152921504606845473): 3291845140097365,
    (32, 576460752303433409): 115052847402750,
    (32, 576460752303418369): 15682395428093020,
    (32, 576460752303432257): 9135023294846619,
    (32, 576460752303418817): 1412798380688691,
    (32, 576460752303431201): 25362134125040617,
    (32, 576460752303419233): 25006648607729663,
    (32, 576460752303430529): 157206941149794,
    (32, 576460752303419393): 28664758514471768,
    (32, 576460752303428929): 94647189089571768,
    (32, 576460752303420833): 30770371675743623,
    (32, 576460752303426721): 11986893993726935,
    (32, 576460752303421121): 22187805374721692,
    (32, 576460752303426241): 32027565495119106,
    (32, 576460752303421217): 186882312549389527,
    (32, 576460752303425441): 4170305259047449,
    (32, 576460752303421441): 57573111303915604,
    (32, 576460752303424801): 14519810275879125,
    (32, 576460752303422369): 8445232959020704,
    (32, 576460752303424673): 4263918261552992,
    (32, 576460752303422881): 6627663172162361,
    (32, 576460752303423649): 15845585460151834,
    (32, 1152921504606844513): 7645792537133126,
    (32, 1152921504606844417): 97466480447807994,
    (32, 1152921504606844289): 84637351468532534,
    (32, 1152921504606843233): 26688048696213787,
    (32, 1152921504606843073): 93716112831614352,
    (32, 1152921504606842753): 99342307636178362,
    (32, 1152921504606841793): 16190264056101170,
    (32, 1125899906843233): 89340628289760,
    (32, 1125899906842177): 3983438608149,
    (32, 1125899906843009): 23304908302335,
    (32, 1125899906842273): 150844171873508,
    (32, 1125899906842817): 12581553119851,
    (32, 1152921504606841441): 1375427009108634,
    (32768, 1152921504606748673): 62213374832584,
    (32768, 576460752315678721): 18640732202100,
    (32768, 576460752297492481): 30175022817000,
    (32768, 576460752315482113): 83571127048592,
    (32768, 576460752298180609): 695977388949,
    (32768, 576460752314368001): 40515634741600,
    (32768, 576460752298835969): 113198997485340,
    (32768, 576460752313712641): 22061889355692,
    (32768, 576460752300015617): 22922808053833,
    (32768, 576460752312696833): 181889361035251,
    (32768, 576460752300113921): 94578215665171,
    (32768, 576460752312401921): 28571021892619,
    (32768, 576460752300310529): 66029607230409,
    (32768, 576460752310730753): 5506406297734,
    (32768, 576460752301096961): 27004384362139,
    (32768, 576460752310468609): 11284488725320,
    (32768, 576460752301228033): 116351778953390,
    (32768, 576460752309288961): 88031191123112,
    (32768, 576460752301391873): 51872697514093,
    (32768, 576460752308273153): 4715456818773,
    (32768, 576460752301785089): 80509112901857,
    (32768, 576460752306339841): 43164581744457,
    (32768, 576460752302080001): 38905843536482,
    (32768, 576460752304832513): 42292479737591,
    (32768, 576460752302473217): 31255176092861,
    (32768, 576460752304439297): 8242615629351,
    (32768, 1152921504606683137): 212089012217363,
    (32768, 1152921504606584833): 92166579128688,
    (32768, 1152921504605962241): 74756755228070,
    (32768, 1152921504604979201): 52069629205452,
    (32768, 1152921504600260609): 27543819356734,
    (32768, 1152921504599080961): 92056553354496,
    (32768, 1152921504598720513): 89492317149395,
    (32768, 1152921504597114881): 5221302781903,
    (32768, 1152921504597016577): 93618622357268,
}


@functools.lru_cache(maxsize=None)
def root_of_unity(order: int, prime: int) -> int:
    """A primitive `order`-th root of unity mod prime.

    Table lookup first (matching the reference cache), else
    generator^((p-1)/order). Reference: number_theory.c:139-157.
    """
    assert (prime - 1) % order == 0, "order must divide p-1"
    cached = _ROU_TABLE.get((order, prime))
    if cached is not None:
        return cached
    g = find_generator(prime)
    result = pow(g, (prime - 1) // order, prime)
    assert result != 1
    return result


def mod_inv(val: int, modulus: int) -> int:
    """Modular inverse (modulus need not be prime)."""
    return pow(val, -1, modulus)


def find_automorphism_index(rot_idx: int, order: int) -> int:
    """Automorphism exponent k for slot-rotation by rot_idx; x -> x^k.

    `order` is 2N. Reference: number_theory.c:187-200
    (Find_automorphism_index with MODULUS = 2N).
    """
    if rot_idx == 0:
        return 1
    if rot_idx == order - 1:
        return rot_idx
    gen = 5 if rot_idx >= 0 else mod_inv(5, order)
    return pow(gen, abs(rot_idx), order)


def precompute_auto_order(auto_idx: int, degree: int) -> list[int]:
    """Precomputed NTT-slot permutation for an automorphism index.

    Matches the reference's Precompute_auto_idx (ckks_key_generator.c) /
    Hw_rotate contract: for NTT-form (bit-reversed evaluation order) data,
    res[j] = src[order[j]].
    """
    # Evaluation points in the reference NTT layout are psi^(2*br(j)+1);
    # automorphism x->x^k sends evaluation at u to evaluation at u^k, i.e.
    # NTT slot holding exponent e moves data from the slot holding e*k.
    log_n = degree.bit_length() - 1
    m = 2 * degree

    def brev(x: int) -> int:
        r = 0
        for _ in range(log_n):
            r = (r << 1) | (x & 1)
            x >>= 1
        return r

    # exponent (odd residue mod 2N) -> slot position
    exp_to_slot = {}
    for j in range(degree):
        exp_to_slot[(2 * brev(j) + 1) % m] = j
    order = [0] * degree
    for j in range(degree):
        e = (2 * brev(j) + 1) % m
        src_e = (e * auto_idx) % m
        order[j] = exp_to_slot[src_e]
    return order
