"""float32 sin, cos and atan2 with the bits of the JAX package's CPU results.

XLA:CPU lowers float32 `sin`, `cos` and `atan2` to calls into the host's C
math library, glibc. Its results are not correctly rounded (about 1.5%,
1.1% and 16% of uniform inputs differ from the rounded float64 value), so a
port that must pick the same RANSAC winner as the JAX package on
near-exact floors has to reproduce glibc's own sequences. This module does
that with elementwise torch ops, which round the same on every device:

- `sinf`, `cosf`: glibc 2.28+'s sysdeps/ieee754/flt-32/s_sinf.c and
  s_cosf.c (the FMA build that x86-64 selects at run time). They widen to
  float64, reduce by one multiply-subtract with pi/2 and evaluate a float64
  polynomial, rounded once to float32. The FMAs are emulated by Dekker's
  exact product and a compensated sum (`_fma64`).
- `atan2f`: glibc's e_atan2f.c and s_atanf.c (the fdlibm float code, all in
  float32 ops, no FMA), with the constants read from the library's tables.

`sinf` and `cosf` take only the fast range reduction, |x| < 120; larger
inputs give NaN. Their callers pass sums of a few angles in [-pi, pi].
XLA:CPU runs with subnormals flushed to zero and these functions do not, so
a subnormal input or quotient is where they can part.
"""

from __future__ import annotations

import numpy as np
import torch

# s_sincosf_data.c: sine polynomial s1..s3, cosine polynomial c0..c4,
# 2/pi scaled by 2^24 for the integer quadrant, and pi/2.
_S1 = float.fromhex("-0x1.555545995a603p-3")
_S2 = float.fromhex("0x1.1107605230bc4p-7")
_S3 = float.fromhex("-0x1.994eb3774cf24p-13")
_C0 = 1.0
_C1 = float.fromhex("-0x1.ffffffd0c621cp-2")
_C2 = float.fromhex("0x1.55553e1068f19p-5")
_C3 = float.fromhex("-0x1.6c087e89a359dp-10")
_C4 = float.fromhex("0x1.99343027bf8c3p-16")
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
# Top 12 bits (exponent and 3 mantissa bits) of |x|'s float32 pattern that
# s_sinf.c compares against: 0.75 (abstop12(pi/4)), 2^-12 and 120.
_TOP12_SMALL = 0x3F4
_TOP12_TINY = 0x398
_TOP12_LIMIT = 0x42F


def _f32_bits(*words: int) -> list:
    return [float(v) for v in np.array(words, dtype=np.uint32).view(np.float32)]


# s_atanf.c: atan(0.5), atan(1), atan(1.5), atan(inf) as hi + lo, and the
# odd/even polynomial (aT[0] is 0x3eaaaaab in the library's table).
_ATANHI = _f32_bits(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATANLO = _f32_bits(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
_AT = _f32_bits(
    0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
    0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7,
)
# e_atan2f.c: pi, pi/2, pi/4 and pi's low part.
_PI, _PI_O_2, _PI_O_4, _PI_LO = _f32_bits(0x40490FDB, 0x3FC90FDB, 0x3F490FDB, 0xB3BBBD2E)


def _split(x: torch.Tensor):
    t = x * 134217729.0  # 2^27 + 1
    hi = t - (t - x)
    return hi, x - hi


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float64 a * b + c: Dekker's exact product, then a compensated sum."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    return s + (err + e)


def _sincos_poly(xr: torch.Tensor, n: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """sinf_poly of sincosf.h in float64: the sine polynomial where `odd` is
    False, else the cosine polynomial, negated in quadrants n & 2."""
    sign = torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).to(torch.float64)
    xs = xr * sign
    x2 = xr * xr
    full = lambda v: torch.full_like(x2, v)
    x3 = xs * x2
    s1 = _fma64(x2, full(_S3), full(_S2))
    x7 = x3 * x2
    sin_p = _fma64(x7, s1, _fma64(x3, full(_S1), xs))
    neg = torch.where((n & 2) != 0, -1.0, 1.0).to(torch.float64)
    x4 = x2 * x2
    c2 = _fma64(x2, neg * _C4, neg * _C3)
    c1 = _fma64(x2, neg * _C1, neg * _C0)
    x6 = x4 * x2
    cos_p = _fma64(x6, c2, _fma64(x4, neg * _C2, c1))
    return torch.where(odd, cos_p, sin_p)


def _sinf_cosf(y: torch.Tensor, cosine: bool) -> torch.Tensor:
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32, got {y.dtype}")
    top = (y.view(torch.int32) >> 20) & 0x7FF
    x = y.to(torch.float64)
    small = top < _TOP12_SMALL
    # reduce_fast: the quadrant from a 2^24-scaled product, then x - n pi/2
    # with one rounding.
    r = x * _HPI_INV
    n = (r.trunc().to(torch.int64) + 0x800000) >> 24
    xr = _fma64(-n.to(torch.float64), torch.full_like(x, _HPI), x)
    n = torch.where(small, torch.zeros_like(n), n)
    xr = torch.where(small, x, xr)
    quadrant = n ^ 1 if cosine else n
    out = _sincos_poly(xr, n, (quadrant & 1) == 1).to(torch.float32)
    tiny = top < _TOP12_TINY
    out = torch.where(tiny, torch.ones_like(y) if cosine else y, out)
    return torch.where(top < _TOP12_LIMIT, out, torch.full_like(y, float("nan")))


def sinf(x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 sin, elementwise, for |x| < 120 (NaN beyond)."""
    return _sinf_cosf(x, cosine=False)


def cosf(x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 cos, elementwise, for |x| < 120 (NaN beyond)."""
    return _sinf_cosf(x, cosine=True)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """s_atanf.c in float32 ops."""
    full = lambda v: torch.full_like(x, v)
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = torch.abs(x)
    one = full(1.0)
    # Argument reduction by interval: 7/16, 11/16, 19/16, 39/16.
    idx = torch.where(ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    reduced = torch.where(
        idx == 0,
        (ax + ax - one) / (ax + full(2.0)),
        torch.where(
            idx == 1,
            (ax - one) / (ax + one),
            torch.where(idx == 2, (ax - full(1.5)) / (ax * full(1.5) + one), full(-1.0) / ax),
        ),
    )
    small = ix < 0x3EE00000
    xr = torch.where(small, x, reduced)
    z = xr * xr
    w = z * z
    s1 = full(_AT[10])
    for k in (8, 6, 4, 2, 0):
        s1 = s1 * w + full(_AT[k])
    s1 = s1 * z
    s2 = full(_AT[9])
    for k in (7, 5, 3, 1):
        s2 = s2 * w + full(_AT[k])
    s2 = s2 * w
    xs = (s1 + s2) * xr
    pick = lambda table: torch.where(
        idx == 0, full(table[0]), torch.where(idx == 1, full(table[1]), torch.where(idx == 2, full(table[2]), full(table[3])))
    )
    hi, lo = pick(_ATANHI), pick(_ATANLO)
    big = hi - ((xs - lo) - xr)
    out = torch.where(small, xr - xs, torch.where(hx < 0, -big, big))
    at_inf = _ATANHI[3] + _ATANLO[3]  # exact in float64, one float32 rounding
    out = torch.where(ix >= 0x4C000000, torch.where(hx > 0, full(at_inf), full(-at_inf)), out)
    out = torch.where(ix < 0x31000000, x, out)
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 atan2(y, x), elementwise (e_atan2f.c)."""
    if y.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {y.dtype} and {x.dtype}")
    y, x = torch.broadcast_tensors(y, x)
    full = lambda v: torch.full_like(x, v)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23
    z = _atanf(torch.abs(y / x))
    z = torch.where(k > 60, full(_PI_O_2 + 0.5 * _PI_LO), z)
    z = torch.where((hx < 0) & (k < -60), full(0.0), z)
    out = torch.where(
        m == 0, z, torch.where(m == 1, -z, torch.where(m == 2, full(_PI) - (z - full(_PI_LO)), (z - full(_PI_LO)) - full(_PI)))
    )
    inf = 0x7F800000
    y_inf = torch.where(hy < 0, full(-_PI_O_2), full(_PI_O_2))
    out = torch.where(iy == inf, y_inf, out)
    x_inf = torch.where(
        iy == inf,
        torch.stack([full(_PI_O_4), full(-_PI_O_4), full(3.0 * _PI_O_4), full(-3.0 * _PI_O_4)])
        .gather(0, m.long()[None])[0],
        torch.stack([full(0.0), full(-0.0), full(_PI), full(-_PI)]).gather(0, m.long()[None])[0],
    )
    out = torch.where(ix == inf, x_inf, out)
    out = torch.where(ix == 0, y_inf, out)
    y_zero = torch.where(m <= 1, y, torch.where(m == 2, full(_PI), full(-_PI)))
    out = torch.where(iy == 0, y_zero, out)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)
    return torch.where((ix > inf) | (iy > inf), x + y, out)
