"""Curve E2 in plain Python integers: the yardstick's group arithmetic.

E2 is the short-Weierstrass curve y^2 = x^3 + a x + b over F_l (l the
curve25519 group order) of the vPIN reference (src/convolution/Client.py
:138-144), with generator G of prime order q.  Every point the served
pipelines make is a known multiple a*G of the generator, so the reference
tracks points as their discrete logs mod q and turns a log into a point only
to compare it with what the program produced.  ``mul_g`` does that with a
fixed-base table of 8-bit windows and Jacobian mixed additions.
"""

from __future__ import annotations

P = 7237005577332262213973186563042994240857116359379907606001950938285454250989
A = 3491403595575449084947959021303599933011749826127899762162894550148391771037
B = 3633908682298454119909199192149978293706667958442512986315258451820769071958
GX = 4561981307020378385254256586024830594940985765081274686120783167106442831732
GY = 684120277165286233470758410892647831027470652988879249692043589061244861334
ORDER = 7237005577332262213973186563042994240704759454384003648147593987722918659549

_INF = (1, 1, 0)
_WINDOW = 8
_TABLE = None


def _dbl(Pt):
    X, Y, Z = Pt
    if Z == 0 or Y == 0:
        return _INF
    XX = X * X % P
    YY = Y * Y % P
    YYYY = YY * YY % P
    ZZ = Z * Z % P
    S = 2 * ((X + YY) ** 2 - XX - YYYY) % P
    M = (3 * XX + A * ZZ * ZZ) % P
    T = (M * M - 2 * S) % P
    return (T, (M * (S - T) - 8 * YYYY) % P, ((Y + Z) ** 2 - YY - ZZ) % P)


def _madd(Pt, x2, y2):
    """Jacobian point + affine point (x2, y2)."""
    X1, Y1, Z1 = Pt
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    r = 2 * (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return _dbl(Pt) if r == 0 else _INF
    HH = H * H % P
    I = 4 * HH
    J = H * I % P
    V = X1 * I % P
    X3 = (r * r - J - 2 * V) % P
    return (X3, (r * (V - X3) - 2 * Y1 * J) % P, ((Z1 + H) ** 2 - Z1Z1 - HH) % P)


def _affine(Pt):
    """-> (x, y, inf) with x = y = 0 at infinity."""
    X, Y, Z = Pt
    if Z == 0:
        return (0, 0, True)
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P, False)


def _table():
    """T[i][d] = d * 2^(8i) * G in affine form, d in [0, 256)."""
    global _TABLE
    if _TABLE is None:
        table, base = [], (GX, GY)
        for _ in range((ORDER.bit_length() + _WINDOW - 1) // _WINDOW):
            row, acc = [None], _INF
            for _ in range(1, 1 << _WINDOW):
                acc = _madd(acc, *base)
                x, y, _inf = _affine(acc)
                row.append((x, y))
            table.append(row)
            nxt = _madd(acc, *base)          # 256 * base
            x, y, _inf = _affine(nxt)
            base = (x, y)
        _TABLE = table
    return _TABLE


def mul_g(a: int):
    """(a mod q) * G as (x, y, inf), x = y = 0 at infinity."""
    a %= ORDER
    acc = _INF
    for row in _table():
        d = a & 0xFF
        if d:
            acc = _madd(acc, *row[d])
        a >>= _WINDOW
        if not a:
            break
    return _affine(acc)


def on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + A * x + B)) % P == 0


def signed(v: int) -> int:
    """A log mod q as the signed integer it stands for (|v| < q / 2)."""
    v %= ORDER
    return v - ORDER if v > ORDER // 2 else v
