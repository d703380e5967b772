"""ReLU under CKKS: composite-polynomial sign approximation.

relu(x) = 0.5 * x * (sign(x) + 1), with sign approximated by a chain of
Chebyshev-basis polynomials evaluated via Paterson-Stockmeyer, exactly
as the reference lowers NN RELU (fhe-cmplr/sihe/src/
tensor2sihe_impl.cxx:306-344 APP_RELU_FUNC_GEN::Gen_func_body).

Coefficient tables are the reference's numeric constants
(fhe-cmplr/util/src/app_composite_poly.cxx:72-180): composite sign
polynomials in the Chebyshev basis at mul_depth 11 (alfa=6) and 13
(alfa=9). Inputs are pre-scaled by 1/value_range into [-1, 1]
(the -SIHE:relu_vr mechanism).
"""

from __future__ import annotations

from ace_tpu_torch.ckks.cheby import ChebyEvaluator
from ace_tpu_torch.ckks.cipher import Ciphertext

# fhe-cmplr/util/src/app_composite_poly.cxx:74-127 (depth 11, alfa 6)
SIGN_CHEBYSHEV_DEPTH11 = [
    [0.0, 1.277209679957775013e+00, 0.0, -4.369818210105346212e-01,
     0.0, 2.781705762612975419e-01, 0.0, -9.522998581241576277e-01],
    [0.0, 1.336811809725395372e+00, 0.0, -3.314086854871873267e-01,
     0.0, 2.739009935511804161e-01, 0.0, -2.096678512577555831e-01,
     0.0, 6.827141455300124451e-02, 0.0, -1.036056317926726048e-02,
     0.0, 7.381161118162535544e-04, 0.0, -2.000350671563594715e-05],
    [0.0, 1.229917329338358289e+00, 0.0, -3.099894039867301943e-01,
     0.0, 1.047929208484282559e-01, 0.0, -3.040264421328875422e-02,
     0.0, 6.507995190210730772e-03, 0.0, -8.815509689332230855e-04,
     0.0, 5.555595810150389487e-05],
]

# fhe-cmplr/util/src/app_composite_poly.cxx:130-180 (depth 13, alfa 9)
SIGN_CHEBYSHEV_DEPTH13 = [
    [0.0, 1.274244441439567055e+00, 0.0, -4.274610154279958607e-01,
     0.0, 2.598417608934820988e-01, 0.0, -1.894160321998888952e-01,
     0.0, 1.516157904980795224e-01, 0.0, -1.289471808964555988e-01,
     0.0, 1.148389592593351827e-01, 0.0, -1.006755030034787834e+00],
    [0.0, 1.504797731281392936e+00, 0.0, -1.262993831946355172e-01,
     0.0, 5.310374803122150933e-01, 0.0, -4.763164287058726520e-01,
     0.0, 1.404090303951424090e-01, 0.0, -1.856485351687612792e-02,
     0.0, 1.142402954164560992e-03, 0.0, -2.667926441648920576e-05],
    [0.0, 1.258870573407572691e+00, 0.0, -3.830661449095234539e-01,
     0.0, 1.909371044429533648e-01, 0.0, -1.025700865042690896e-01,
     0.0, 5.364833181833868897e-02, 0.0, -2.602904444646918572e-02,
     0.0, 1.119529495100999271e-02, 0.0, -3.976394146723259693e-03,
     0.0, 1.080475747158062428e-03, 0.0, -2.115428631766840754e-04,
     0.0, 2.840163212584644305e-05, 0.0, -2.461531419370990484e-06,
     0.0, 1.235599278444410819e-07, 0.0, -2.723078631019510824e-09],
]

# fhe-cmplr/util/src/app_composite_poly.cxx:24-45 (depth 9, alfa 5):
# the reference's POWER-basis pair (degrees 15 and 29). We evaluate in
# the Chebyshev basis (numerically better conditioned on [-1,1]; the
# conversion poly2cheb is an exact linear basis change), which keeps
# one BSGS evaluator for every depth. PS depth: ceil(log2(15))=4 +
# ceil(log2(29))=5 -> 9 mul levels, the reference's relu_depth=9 that
# build_resnet20_cifar10.sh selects for all ResNets.
SIGN_POWER_DEPTH9 = [
    [0., 16.991912801003051892923261, 0., -394.30462944608592454353314,
     0., 3732.9438341250469929346644, 0., -16694.033300999042855833984,
     0., 39329.431040775967515596684, 0., -50248.794119518568012111608,
     0., 32926.27463357162420222774, 0., -8667.9902964915960941020499],
    [0., 4.9658644770032308652625025, 0., -29.448884583925814589495991,
     0., 139.78371088903676355969164, 0., -465.9336214215280025199331,
     0., 1115.8611769977060195196749, 0., -1965.3906607101910315340303,
     0., 2585.8860916290664168457066, 0., -2562.0785113031476588750824,
     0., 1913.2925184471942343973977, 0., -1069.5452820334728267866371,
     0., 440.19390573542399694605194, 0., -129.32576670397024386464789,
     0., 25.645293406943162690472632, 0., -3.0739777273880675957413278,
     0., 0.16814265087412611753805143],
]


def _pow2cheb_normalized(tables):
    """Power-basis composite -> Chebyshev-basis composite with every
    intermediate normalized into [-1, 1].

    The raw depth-9 pair has p0([-1,1]) = [-1.481, 1.481]; Chebyshev
    recurrences at |y| > 1 grow like (y + sqrt(y^2-1))^k, so feeding
    p1 (degree 29) the raw p0 output explodes T_29 by ~1e12. Folding
    1/c into p0's coefficients and substituting y = c*u into p1 keeps
    the composite value-identical while every stage maps [-1,1] ->
    [-1,1] (cheb coeffs stay O(1); verified max sign error 5.5e-6,
    same as the power-basis original)."""
    import numpy as _np
    from numpy.polynomial import chebyshev as _C, polynomial as _P
    out = []
    scale = 1.0
    for t in tables:
        p = _np.asarray(t, dtype=_np.float64)
        p = p * scale ** _np.arange(len(p))        # absorb prior 1/c
        c = float(_np.max(_np.abs(_P.polyval(
            _np.linspace(-1.0, 1.0, 100001), p))))
        c = max(c, 1.0)
        cheb = list(_C.poly2cheb(p / c))
        # eval_chebyshev halves c0 at entry (the reference's doubled-c0
        # contract); these plain-convention series are only safe to
        # feed it because sign stages are odd (c0 == 0, as are all even
        # coefficients) — guard against a future non-odd table here
        assert all(abs(v) < 1e-12 for v in cheb[0::2]), \
            "sign stage must be odd (doubled-c0 contract)"
        out.append(cheb)
        scale = c
    # the LAST stage must return the true (unscaled) sign value
    if scale != 1.0:
        out[-1] = [v * scale for v in out[-1]]
    return out


SIGN_TABLES = {9: _pow2cheb_normalized(SIGN_POWER_DEPTH9),
               11: SIGN_CHEBYSHEV_DEPTH11,
               13: SIGN_CHEBYSHEV_DEPTH13}


def sign_composite(ev, ct: Ciphertext, mul_depth: int = 13,
                   fold_half: bool = False) -> Ciphertext:
    """sign(x) for x in [-1, 1] via the composite Chebyshev chain.

    fold_half: evaluate 0.5*(sign(x)+1) instead by scaling the LAST
    polynomial's Chebyshev coefficients by 0.5 and adding 0.5 to the
    constant term (c0 carries the /2 convention) — the reference's
    merge of the ReLU affine factor into the outermost polynomial
    (tensor2sihe_impl.cxx:322)."""
    cheby = ChebyEvaluator(ev)
    out = ct
    tables = SIGN_TABLES[mul_depth]
    for i, coeffs in enumerate(tables):
        if fold_half and i == len(tables) - 1:
            coeffs = [0.5 * c for c in coeffs]
            coeffs[0] += 1.0  # +0.5 in the c0/2 convention
        out = cheby.eval_chebyshev(out, coeffs, -1.0, 1.0)
    return out


def relu(ev, ct: Ciphertext, value_range: float = 1.0,
         mul_depth: int = 13) -> Ciphertext:
    """relu(x) = x * [0.5*(sign(x/range) + 1)], with the affine factor
    folded into the outermost composite polynomial (one level cheaper
    than forming 0.5*x separately)."""
    scaled = ct if value_range == 1.0 else \
        ev.rescale(ev.mul_const(ct, 1.0 / value_range))
    s = sign_composite(ev, scaled, mul_depth, fold_half=True)
    while s.sf_degree > 1:
        s = ev.rescale(s)
    x = ct
    while x.sf_degree > 1:
        x = ev.rescale(x)
    while x.level > s.level:
        x = ev.mod_switch(x)
    return ev.rescale(ev.mul(x, s))
