"""Host-side exact elliptic-curve reference (pure Python ints).

Replaces the reference's dependency on python-ecdsa
(reference: src/convolution/Client.py:2, CurveFp/Point usage at :134-156)
for ground truth in tests and for small host-side protocol steps.
Affine short-Weierstrass arithmetic; infinity is an explicit flag.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HostCurve:
    p: int
    a: int
    b: int

    def is_on_curve(self, P: "HostPoint") -> bool:
        if P.inf:
            return True
        return (P.y * P.y - (P.x**3 + self.a * P.x + self.b)) % self.p == 0


class HostPoint:
    """Immutable affine point; supports +, scalar *, unary -."""

    __slots__ = ("curve", "x", "y", "inf")

    def __init__(self, curve, x=0, y=0, inf=False):
        self.curve = curve
        self.x = x % curve.p if not inf else 0
        self.y = y % curve.p if not inf else 0
        self.inf = inf

    def __eq__(self, other):
        if not isinstance(other, HostPoint):
            return NotImplemented
        if self.inf or other.inf:
            return self.inf and other.inf
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.inf, self.x, self.y))

    def __neg__(self):
        if self.inf:
            return self
        return HostPoint(self.curve, self.x, -self.y % self.curve.p)

    def __add__(self, other):
        c = self.curve
        p = c.p
        if self.inf:
            return other
        if other.inf:
            return self
        if self.x == other.x:
            if (self.y + other.y) % p == 0:
                return HostPoint(c, inf=True)
            s = (3 * self.x * self.x + c.a) * pow(2 * self.y, -1, p) % p
        else:
            s = (other.y - self.y) * pow(other.x - self.x, -1, p) % p
        x3 = (s * s - self.x - other.x) % p
        y3 = (s * (self.x - x3) - self.y) % p
        return HostPoint(c, x3, y3)

    def __mul__(self, k: int):
        if k < 0:
            return (-self) * (-k)
        acc = HostPoint(self.curve, inf=True)
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add + add
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __repr__(self):
        return "INF" if self.inf else f"({self.x}, {self.y})"


# --- Curve E2 parameters (behavioral constants from the reference,
#     src/convolution/Client.py:138-144) ---
E2_P = 7237005577332262213973186563042994240857116359379907606001950938285454250989
E2_A = 3491403595575449084947959021303599933011749826127899762162894550148391771037
E2_B = 3633908682298454119909199192149978293706667958442512986315258451820769071958
E2_GX = 4561981307020378385254256586024830594940985765081274686120783167106442831732
E2_GY = 684120277165286233470758410892647831027470652988879249692043589061244861334
E2_ORDER = 7237005577332262213973186563042994240704759454384003648147593987722918659549

E2_HOST = HostCurve(E2_P, E2_A, E2_B)
E2_G_HOST = HostPoint(E2_HOST, E2_GX, E2_GY)


def host_infinity(curve: HostCurve = E2_HOST) -> HostPoint:
    return HostPoint(curve, inf=True)
