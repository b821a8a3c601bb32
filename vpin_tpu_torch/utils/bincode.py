"""bincode-compatible proof serialization (sat proof, sigma proofs, ZK
sumcheck, the SPARK eval proof, CPSnarkProof and the stock SNARK, NIZK).

Port of vpin_tpu/utils/bincode.py.  The wire format: little-endian u64 length prefixes for
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


def ser_poly_commitment(w: Writer, c) -> None:
    w.vec(c.C, w.point)


def ser_zk_sumcheck(w: Writer, sc) -> None:
    w.vec(sc.comm_polys, w.point)
    w.vec(sc.comm_evals, w.point)
    w.vec(sc.proofs, lambda p: ser_dotproduct(w, p))


def ser_r1cs_sat_proof(w: Writer, p) -> None:
    ser_poly_commitment(w, p.comm_vars)
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


def ser_layer_proof_batched(w: Writer, lp) -> None:
    # the layer's SumcheckInstanceProof: Vec<CompressedUniPoly>
    w.vec(lp.compressed_polys, lambda coeffs: w.vec(coeffs, w.scalar))
    w.vec(lp.claims_prod_left, w.scalar)
    w.vec(lp.claims_prod_right, w.scalar)


def ser_prod_circuit_batched(w: Writer, p) -> None:
    w.vec(p.proof, lambda lp: ser_layer_proof_batched(w, lp))
    for part in p.claims_dotp:         # tuple of three Vec<Scalar>
        w.vec(part, w.scalar)


def ser_hash_layer(w: Writer, p) -> None:
    for grp in (p.eval_row, p.eval_col):
        w.vec(grp[0], w.scalar)
        w.vec(grp[1], w.scalar)
        w.scalar(grp[2])
    w.vec(p.eval_val, w.scalar)
    w.vec(p.eval_derefs[0], w.scalar)
    w.vec(p.eval_derefs[1], w.scalar)
    ser_polyeval(w, p.proof_ops)
    ser_polyeval(w, p.proof_mem)
    ser_polyeval(w, p.proof_derefs.proof_derefs)


def ser_eval_network(w: Writer, p) -> None:
    # ProductLayerProof field order: eval_row, eval_col, eval_val,
    # proof_mem, proof_ops
    pl = p.proof_prod_layer
    for grp in (pl.eval_row, pl.eval_col):
        w.scalar(grp[0])
        w.vec(grp[1], w.scalar)
        w.vec(grp[2], w.scalar)
        w.scalar(grp[3])
    w.vec(pl.eval_val[0], w.scalar)
    w.vec(pl.eval_val[1], w.scalar)
    ser_prod_circuit_batched(w, pl.proof_mem)
    ser_prod_circuit_batched(w, pl.proof_ops)
    ser_hash_layer(w, p.proof_hash_layer)


def ser_sparse_eval_proof(w: Writer, p) -> None:
    ser_poly_commitment(w, p.comm_derefs)
    ser_eval_network(w, p.poly_eval_network_proof)


def serialize_snark(proof) -> bytes:
    """CPSnarkProof -> bincode bytes (the SNARK struct: sat proof,
    inst_evals, then the eval proof when there is one)."""
    w = Writer()
    ser_r1cs_sat_proof(w, proof.r1cs_sat_proof)
    for v in proof.inst_evals:
        w.scalar(v)
    if proof.r1cs_eval_proof is not None:
        ser_sparse_eval_proof(w, proof.r1cs_eval_proof.proof)
    return w.bytes()


def serialize_nizk(proof) -> bytes:
    """NIZK -> bincode bytes (lib.rs NIZK struct: sat proof, then (rx, ry))."""
    w = Writer()
    ser_r1cs_sat_proof(w, proof.r1cs_sat_proof)
    w.vec(proof.r[0], w.scalar)
    w.vec(proof.r[1], w.scalar)
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


def des_poly_commitment(r: Reader):
    from ..snark.r1csproof import PolyCommitment
    return PolyCommitment(r.vec(r.point))


def des_r1cs_sat_proof(r: Reader):
    from ..snark.r1csproof import R1CSProof
    comm_vars = des_poly_commitment(r)
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


def des_layer_proof_batched(r: Reader):
    from ..spark.product_tree import LayerProofBatched
    polys = r.vec(lambda: r.vec(r.scalar))
    return LayerProofBatched(polys, r.vec(r.scalar), r.vec(r.scalar))


def des_prod_circuit_batched(r: Reader):
    from ..spark.product_tree import ProductCircuitEvalProofBatched
    proof = r.vec(lambda: des_layer_proof_batched(r))
    claims_dotp = tuple(r.vec(r.scalar) for _ in range(3))
    return ProductCircuitEvalProofBatched(proof, claims_dotp)


def des_hash_layer(r: Reader):
    from ..spark.sparse_mlpoly import DerefsEvalProof, HashLayerProof
    groups = [(r.vec(r.scalar), r.vec(r.scalar), r.scalar()) for _ in range(2)]
    eval_val = r.vec(r.scalar)
    eval_derefs = (r.vec(r.scalar), r.vec(r.scalar))
    proof_ops = des_polyeval(r)
    proof_mem = des_polyeval(r)
    proof_derefs = DerefsEvalProof(des_polyeval(r))
    return HashLayerProof(groups[0], groups[1], eval_val, eval_derefs,
                          proof_ops, proof_mem, proof_derefs)


def des_eval_network(r: Reader):
    from ..spark.sparse_mlpoly import PolyEvalNetworkProof, ProductLayerProof
    groups = [(r.scalar(), r.vec(r.scalar), r.vec(r.scalar), r.scalar())
              for _ in range(2)]
    eval_val = (r.vec(r.scalar), r.vec(r.scalar))
    proof_mem = des_prod_circuit_batched(r)
    proof_ops = des_prod_circuit_batched(r)
    pl = ProductLayerProof(groups[0], groups[1], eval_val, proof_mem,
                           proof_ops)
    return PolyEvalNetworkProof(pl, des_hash_layer(r))


def des_sparse_eval_proof(r: Reader):
    from ..spark.sparse_mlpoly import R1CSEvalProof, SparseMatPolyEvalProof
    comm_derefs = des_poly_commitment(r)
    return R1CSEvalProof(SparseMatPolyEvalProof(comm_derefs,
                                                des_eval_network(r)))


def deserialize_snark(data: bytes):
    """bincode bytes -> CPSnarkProof, with or without the eval proof (the
    bytes after inst_evals); trailing bytes after it raise."""
    from ..snark.cp_snark import CPSnarkProof
    r = Reader(data)
    sat = des_r1cs_sat_proof(r)
    evals = tuple(r.scalar() for _ in range(3))
    eval_proof = None
    if r.off != len(data):
        eval_proof = des_sparse_eval_proof(r)
        if r.off != len(data):
            raise ValueError("trailing bytes after the eval proof")
    return CPSnarkProof(sat, evals, eval_proof)


def deserialize_nizk(data: bytes):
    """bincode bytes -> NIZK; trailing bytes raise."""
    from ..snark.nizk_api import NIZK
    r = Reader(data)
    sat = des_r1cs_sat_proof(r)
    rx = r.vec(r.scalar)
    ry = r.vec(r.scalar)
    if r.off != len(data):
        raise ValueError("trailing bytes after the NIZK proof")
    return NIZK(sat, (rx, ry))


# ----------------------------------------------------------------------
# sizes from an instance's shape
# ----------------------------------------------------------------------

def _log2_ceil(n: int) -> int:
    """log2 of the power of two at or above n."""
    return (max(n, 1) - 1).bit_length()


def _vec(k: int) -> int:
    return 8 + 32 * k


def _polyeval(nvars: int) -> int:
    """A PolyEvalProof over nvars variables: bullet L and R, delta, beta,
    z1, z2."""
    return 2 * _vec(nvars - nvars // 2) + 4 * 32


def sat_proof_size(num_cons: int, num_vars: int) -> int:
    """Bytes of a CPSnarkProof without the eval proof (the sat proof and the
    three instance evaluations) for an R1CS instance with these counts, as
    vpin_tpu's size() methods reckon them (snark/r1csproof.py): the
    witness's Hyrax rows, two zero-knowledge sumchecks (cubic over the
    constraints, quadratic over twice the variables), the claims and their
    sigma proofs, and the witness's opening."""
    x, s = _log2_ceil(max(num_cons, 2)), _log2_ceil(max(num_vars, 2))

    def sumcheck(rounds, degree):     # comm_polys, comm_evals, dot products
        return 2 * _vec(rounds) + 8 + rounds * (4 * 32 + _vec(degree + 1))

    return (_vec(1 << (s // 2)) + sumcheck(x, 3)
            + 4 * 32 + 3 * 32 + 8 * 32 + 2 * 32  # claims, knowledge, product, eq
            + sumcheck(s + 1, 2) + 32 + _polyeval(s)  # comm_vars_at_ry, opening
            + 2 * 32 + 3 * 32)                   # eq; inst_evals


def eval_proof_size(num_cons: int, num_vars: int, nnz: int) -> int:
    """Bytes of the SPARK eval proof of an R1CS instance with these counts
    (one input) and at most ``nnz`` entries a matrix: the derefs' Hyrax
    rows, the product layer (two batched product-circuit proofs) and the
    hash layer (three PolyEvalProofs)."""
    batch = 3                          # the matrices A, B and C
    cells = max(_log2_ceil(max(num_cons, 2)),
                _log2_ceil(max(num_vars, 2)) + 1)
    N = _log2_ceil(nnz)

    def product_proof(K, leaves, k2):  # layer i has i cubic rounds
        return 8 + sum(8 + i * _vec(3) + 2 * _vec(K)
                       for i in range(leaves)) + 3 * _vec(k2)

    ops_vars = N + _log2_ceil(5 * batch)
    derefs_vars = N + _log2_ceil(2 * batch)
    product_layer = (2 * (2 * 32 + 2 * _vec(batch)) + 2 * _vec(batch)
                     + product_proof(4, cells, 0)
                     + product_proof(4 * batch, N, 2 * batch))
    hash_layer = (2 * (2 * _vec(batch) + 32) + 3 * _vec(batch)
                  + _polyeval(ops_vars) + _polyeval(cells + 1)
                  + _polyeval(derefs_vars))
    return _vec(1 << (derefs_vars // 2)) + product_layer + hash_layer


def snark_size(num_cons: int, num_vars: int, nnz: int,
               full_snark: bool) -> int:
    """Bytes of serialize_snark's output for a CP-SNARK of an instance with
    these counts: the sat proof and, in full, the eval proof."""
    return sat_proof_size(num_cons, num_vars) + (
        eval_proof_size(num_cons, num_vars, nnz) if full_snark else 0)
