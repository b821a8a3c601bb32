"""bincode-compatible proof serialization (sat proof, sigma proofs, ZK
sumcheck, CPSnarkProof).

Port of vpin_tpu/utils/bincode.py without the SPARK eval-proof parts, which
are not ported yet.  The wire format: little-endian u64 length prefixes for
Vec<T>, raw fixed-size arrays, struct fields in declaration order; scalars
and compressed ristretto points are 32-byte arrays (reference measures proof
size as bincode::serialize(...).len(), proof_point_add.rs:96-98).
"""

from __future__ import annotations

import struct
from typing import List

from ..field.prime_field import L_MODULUS as _L

_R256 = (1 << 256) % _L
_R256_INV = pow(_R256, -1, _L)


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def u64(self, n: int) -> "Writer":
        self.buf += struct.pack("<Q", n)
        return self

    def scalar(self, v: int) -> "Writer":
        # the reference Scalar serializes its Montgomery [u64; 4] form
        self.buf += (int(v) % _L * _R256 % _L).to_bytes(32, "little")
        return self

    def point(self, b: bytes) -> "Writer":
        if len(b) != 32:
            raise ValueError("a compressed point is 32 bytes")
        self.buf += b
        return self

    def vec(self, items, fn) -> "Writer":
        self.u64(len(items))
        for it in items:
            fn(it)
        return self

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u64(self) -> int:
        if self.off + 8 > len(self.data):
            raise ValueError("truncated buffer (u64)")
        v = struct.unpack_from("<Q", self.data, self.off)[0]
        self.off += 8
        return v

    def raw(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("truncated buffer (raw)")
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def scalar(self) -> int:
        return int.from_bytes(self.raw(32), "little") * _R256_INV % _L

    def point(self) -> bytes:
        return self.raw(32)

    def vec(self, fn) -> List:
        n = self.u64()
        # every element takes at least one byte: a corrupted length prefix
        # fails fast instead of driving a huge loop
        if n > len(self.data) - self.off:
            raise ValueError("vec length exceeds buffer")
        return [fn() for _ in range(n)]


# ----------------------------------------------------------------------
# serializers (field order == reference struct order)
# ----------------------------------------------------------------------

def ser_knowledge(w: Writer, p) -> None:
    w.point(p.alpha).scalar(p.z1).scalar(p.z2)


def ser_equality(w: Writer, p) -> None:
    w.point(p.alpha).scalar(p.z)


def ser_product(w: Writer, p) -> None:
    w.point(p.alpha).point(p.beta).point(p.delta)
    for z in p.z:                      # [Scalar; 5] fixed array, no prefix
        w.scalar(z)


def ser_dotproduct(w: Writer, p) -> None:
    w.point(p.delta).point(p.beta)
    w.vec(p.z, w.scalar)
    w.scalar(p.z_delta).scalar(p.z_beta)


def ser_polyeval(w: Writer, p) -> None:
    d = p.proof                        # DotProductProofLog
    w.vec(d.bullet.L_vec, w.point)
    w.vec(d.bullet.R_vec, w.point)
    w.point(d.delta).point(d.beta).scalar(d.z1).scalar(d.z2)


def ser_zk_sumcheck(w: Writer, sc) -> None:
    w.vec(sc.comm_polys, w.point)
    w.vec(sc.comm_evals, w.point)
    w.vec(sc.proofs, lambda p: ser_dotproduct(w, p))


def ser_r1cs_sat_proof(w: Writer, p) -> None:
    w.vec(p.comm_vars.C, w.point)
    ser_zk_sumcheck(w, p.sc_proof_phase1)
    for c in p.claims_phase2:          # tuple of 4 compressed points
        w.point(c)
    ser_knowledge(w, p.pok_claims_phase2[0])
    ser_product(w, p.pok_claims_phase2[1])
    ser_equality(w, p.proof_eq_sc_phase1)
    ser_zk_sumcheck(w, p.sc_proof_phase2)
    w.point(p.comm_vars_at_ry)
    ser_polyeval(w, p.proof_eval_vars_at_ry)
    ser_equality(w, p.proof_eq_sc_phase2)


def serialize_snark(proof) -> bytes:
    """CPSnarkProof -> bincode bytes (sat proof, inst_evals)."""
    if proof.r1cs_eval_proof is not None:
        raise NotImplementedError("SPARK eval proof not ported yet")
    w = Writer()
    ser_r1cs_sat_proof(w, proof.r1cs_sat_proof)
    for v in proof.inst_evals:
        w.scalar(v)
    return w.bytes()


# ----------------------------------------------------------------------
# deserializers (mirror the ser_* field order exactly)
# ----------------------------------------------------------------------

def des_knowledge(r: Reader):
    from ..nizk.sigma import KnowledgeProof
    return KnowledgeProof(r.point(), r.scalar(), r.scalar())


def des_equality(r: Reader):
    from ..nizk.sigma import EqualityProof
    return EqualityProof(r.point(), r.scalar())


def des_product(r: Reader):
    from ..nizk.sigma import ProductProof
    alpha, beta, delta = r.point(), r.point(), r.point()
    z = tuple(r.scalar() for _ in range(5))
    return ProductProof(alpha, beta, delta, z)


def des_dotproduct(r: Reader):
    from ..nizk.sigma import DotProductProof
    delta, beta = r.point(), r.point()
    z = r.vec(r.scalar)
    return DotProductProof(delta, beta, z, r.scalar(), r.scalar())


def des_polyeval(r: Reader):
    from ..nizk.sigma import BulletReductionProof, DotProductProofLog
    from ..snark.r1csproof import PolyEvalProof
    L_vec = r.vec(r.point)
    R_vec = r.vec(r.point)
    return PolyEvalProof(DotProductProofLog(
        BulletReductionProof(L_vec, R_vec),
        r.point(), r.point(), r.scalar(), r.scalar()))


def des_zk_sumcheck(r: Reader):
    from ..sumcheck.sumcheck import ZKSumcheckInstanceProof
    comm_polys = r.vec(r.point)
    comm_evals = r.vec(r.point)
    proofs = r.vec(lambda: des_dotproduct(r))
    return ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs)


def des_r1cs_sat_proof(r: Reader):
    from ..snark.r1csproof import PolyCommitment, R1CSProof
    comm_vars = PolyCommitment(r.vec(r.point))
    sc1 = des_zk_sumcheck(r)
    claims = tuple(r.point() for _ in range(4))
    pok = (des_knowledge(r), des_product(r))
    eq1 = des_equality(r)
    sc2 = des_zk_sumcheck(r)
    comm_vars_at_ry = r.point()
    pe = des_polyeval(r)
    eq2 = des_equality(r)
    return R1CSProof(comm_vars, sc1, claims, pok, eq1, sc2,
                     comm_vars_at_ry, pe, eq2)


def deserialize_snark(data: bytes):
    """bincode bytes -> CPSnarkProof.  Trailing bytes would be a SPARK eval
    proof, which is not ported yet: they raise."""
    from ..snark.cp_snark import CPSnarkProof
    r = Reader(data)
    sat = des_r1cs_sat_proof(r)
    evals = tuple(r.scalar() for _ in range(3))
    if r.off != len(data):
        raise ValueError("trailing bytes: the SPARK eval proof is not "
                         "ported yet")
    return CPSnarkProof(sat, evals)
