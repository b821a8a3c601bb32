"""Proving: one prover in a closed loop.  Each step proves one request's
recorded witness with the point-add or the point-mult CP-SNARK, as the mix
says (with or without the SPARK eval proof), then verifies it on the host,
as runner/bench.py's proof phases do.

The witnesses come from distinct single-conv requests served in set-up,
each with its image, nonces and rLC keys from the seed; step i proves
witness i mod ``traces`` with a tape seed of its own.

What is compared once the window has closed:
  commitment_mismatch  proofs of the window whose witness commitments
                    (the para and input rows each was verified against,
                    caught at the program's cp_snark_verify) differ from
                    those of the reference's own witness of the request with
                    the blinds of the step's tape seed, plus the proofs that
                    never passed the verifier.  The rows are compared
                    through one random linear combination with 128-bit
                    coefficients from the seed (reference/spartan.py
                    rows_combine: exact group arithmetic, two row-width MSMs
                    a share): a proof that verifies is then a proof of the
                    reference's witness
  instance_mismatch  proofs verified against an instance (the counts and
                    every entry of A, B and C, caught at cp_snark_verify)
                    other than the reference's circuit of as many
                    operations, padded as Spartan pads it: a circuit with a
                    constraint dropped or weakened proves faster and still
                    verifies
  witness_mismatch  every value handed to the prover (points, scalars,
                    infinity flags) against the reference's witness of the
                    same request, recomputed from the inputs
  size_mismatch     proofs whose size differs from the configuration's
                    (the instance's shape fixes the size)
  rejected          proofs the verifier did not accept
"""

from __future__ import annotations

import random
from typing import Dict, List

from .. import inputs
from ..reference import e2, pipeline, spartan
from ..work import counts


class Driver:
    kind = "proof"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.gadget = self.mix["gadget"]
        spartan.layout(self.gadget)         # the reference can commit it
        self.full = bool(self.mix["full_snark"])
        self.proof = self.cfg["proofs"][self.gadget]
        self.size = int(self.mix["size"])
        self.stats: List[Dict] = []
        self.verified: List[tuple] = []
        self.rejected = 0
        self._saved = None

    def setup(self):
        from vpin_tpu_torch.nn.elgamal import KeyPair
        from vpin_tpu_torch.nn.models import run_conv_workload
        from vpin_tpu_torch.runner.proof_runner import trace_args
        seed, dev = self.ctx.seed, self.ctx.device
        self.x = inputs.secret_key(seed)
        key = KeyPair.from_secret(self.x, device=dev)
        self.args = []
        for t in range(int(self.mix["traces"])):
            rng = random.Random(inputs.nonce_seed(seed, t))
            keys = inputs.key_source(inputs.rlc_keys(seed, t, 2))
            res = run_conv_workload(
                inputs.image(seed, t, self.size), self.cfg["filter_size"],
                key, rng, padding=self.cfg["padding"],
                stride=self.cfg["stride"], key_source=keys)
            add, mult = trace_args(res.trace.finalize())
            self.args.append(self._cut(add if self.gadget == "add" else mult))
        if self.ctx.control:
            self.args = [alter(a) for a in self.args]
        self._catch_commitments()
        self._prove(self.args[0], inputs.tape_seed(seed, "warm"))
        self.stats = []
        self.verified.clear()

    def _catch_commitments(self):
        """Keep, for each proof verified, the witness commitments (row
        bytes) and the instance (its counts and the host arrays of its
        matrices, by reference) that the program's verifier checked it
        against."""
        from vpin_tpu_torch.runner import proof_runner as pr
        verify, verified = pr.cp_snark_verify, self.verified

        def caught(proof, inst, inputs_, transcript, gens, comm_para,
                   comm_input, comm=None):
            mats = tuple((m.rows, m.cols, m.codes, m.codebook)
                         for m in (inst.A, inst.B, inst.C))
            verified.append((list(comm_para.C), list(comm_input.C),
                             (inst.num_cons, inst.num_vars, inst.num_inputs,
                              mats)))
            return verify(proof, inst, inputs_, transcript, gens, comm_para,
                          comm_input, comm=comm)

        self._saved = (pr, verify)
        pr.cp_snark_verify = caught

    def _cut(self, args):
        """The first ``witness_slice`` entries of each argument, where the
        mix asks for fewer than the whole witness (the tests' small
        proofs)."""
        k = self.mix.get("witness_slice")
        return tuple(a[:k] for a in args) if k else tuple(args)

    def _prove(self, args, tape_seed):
        from vpin_tpu_torch.runner import proof_runner as pr
        kw = dict(tape_seed=tape_seed, quiet=True, device=self.ctx.device,
                  full_snark=self.full)
        if self.gadget == "add":
            return pr.prove_point_add(*args, **kw)
        return pr.prove_point_mult(*args, n_bits=self.proof["n_bits"], **kw)

    def step(self, i: int) -> Dict:
        j = i % len(self.args)
        caught = len(self.verified)
        try:
            st = self._prove(self.args[j], inputs.tape_seed(self.ctx.seed, i))
        except AssertionError as e:
            if "verification failed" in str(e):
                self.rejected += 1
            raise
        finally:
            if len(self.verified) > caught:
                self.verified[caught:] = [(i, j) + self.verified[-1]]
        self.stats.append({"step": i, "trace": j, "bytes": st.size_bytes})
        return {"bytes": st.size_bytes}

    def release(self):
        if self._saved:
            pr, verify = self._saved
            pr.cp_snark_verify = verify
            self._saved = None

    def work(self, i: int) -> int:
        p = self.proof
        return counts.prove(p["r1cs"], self.full, self.gadget, p["count"],
                            p.get("n_bits", 0))

    # ------------------------------------------------------------- checks
    def reference_args(self, t: int):
        """The values the prover should get for witness t: the reference's
        witness of request t in trace_args' layout."""
        seed = self.ctx.seed
        ref = pipeline.conv_request(
            self.cfg, inputs.image(seed, t, self.size), self.x,
            inputs.nonce_seed(seed, t),
            inputs.key_source(inputs.rlc_keys(seed, t, 2)), pixels=[])
        return self._cut(witness_args(ref.witness, self.gadget))

    def checks(self) -> Dict[str, tuple]:
        lim = self.mix["limits"]
        used = sorted({s["trace"] for s in self.stats}
                      | {v[1] for v in self.verified})
        want_args = {t: self.reference_args(t) for t in used}
        comm_bad = inst_bad = 0
        judged, seed = {}, self.ctx.seed
        for i, j, para, inp, inst in self.verified:
            comm_bad += spartan.rows_at_fault(
                self.gadget, want_args[j], inputs.tape_seed(seed, i), para,
                inp, inputs.subseed(seed, "rows", i))
            key = instance_key(inst)
            if key not in judged:
                judged[key] = instance_at_fault(
                    self.gadget, len(want_args[j][0]), inst)
            inst_bad += judged[key]
        # a proof that ended without passing the verifier has no
        # commitments or instance to compare: it counts as at fault in both
        seen = {v[0] for v in self.verified}
        unseen = sum(s["step"] not in seen for s in self.stats)
        comm_bad += unseen
        inst_bad += unseen
        wit_bad = 0
        for t in used:
            want = want_args[t]
            got = self.args[t]
            if len(got) != len(want):
                wit_bad += 1
                continue
            for g, w in zip(got, want):
                if len(g) != len(w):
                    wit_bad += 1 + abs(len(g) - len(w))
                    continue
                wit_bad += sum(int(int(a) != int(b)) for a, b in zip(g, w))
        want_bytes = self.proof["bytes"]["full" if self.full else "transparent"]
        size_bad = sum(int(s["bytes"] != want_bytes) for s in self.stats)
        return {"commitment_mismatch": (comm_bad, lim["commitment_mismatch"]),
                "instance_mismatch": (inst_bad, lim["instance_mismatch"]),
                "witness_mismatch": (wit_bad, lim["witness_mismatch"]),
                "size_mismatch": (size_bad, lim["size_mismatch"]),
                "rejected": (self.rejected, lim["rejected"])}


def instance_key(inst) -> tuple:
    """What tells two caught instances apart: their counts and the bytes
    of their matrices' arrays."""
    counts, mats = inst[:3], inst[3]
    return counts + tuple(
        (rows.tobytes(), cols.tobytes(), codes.tobytes(), tuple(book))
        for rows, cols, codes, book in mats)


def instance_at_fault(gadget: str, count: int, inst) -> bool:
    """Whether a caught instance differs from the reference's circuit of
    ``count`` operations of ``gadget`` (reference/spartan.py instance)."""
    mats = [(rows.tolist(), cols.tolist(), [book[k] for k in codes.tolist()])
            for rows, cols, codes, book in inst[3]]
    return spartan.canonical(*inst[:3], mats) != spartan.instance(gadget,
                                                                  count)


def witness_args(wit: pipeline.Witness, gadget: str):
    """(px, py, rx, ry, rz) of the adds or (scalars, px, py) of the mults,
    affine, as proof_runner.trace_args lays them out (infinity: 0, 0)."""
    if gadget == "add":
        left = [e2.mul_g(a) for a in wit.add_left]
        right = [e2.mul_g(a) for a in wit.add_right]
        return ([p[0] for p in left], [p[1] for p in left],
                [p[0] for p in right], [p[1] for p in right],
                [1 if p[2] else 0 for p in right])
    bases = [e2.mul_g(a) for a in wit.mult_bases]
    return (list(wit.mult_scalars), [p[0] for p in bases],
            [p[1] for p in bases])


def alter(args):
    """The control: the first value handed to the prover moved by one (an
    add's left x, a mult's scalar), so that the proof is of a witness the
    request did not record."""
    first = list(args[0])
    first[0] = int(first[0]) + 1
    return (first,) + tuple(args[1:])
