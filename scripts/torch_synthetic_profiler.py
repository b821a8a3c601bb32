#!/usr/bin/env python3
"""Synthetic stock-SNARK (and NIZK) profiler points of the PyTorch/CUDA port.

The reference's profiler sweeps synthetic R1CS instances from 2^10 to 2^20
(Spartan/profiler/snark.rs:19); scripts/synthetic_profiler.py records that
flow for vpin_tpu.  This script runs it on the port, on the GPU unless
``--device cpu``: produce_synthetic_r1cs(2^k, 2^k, inputs, seed),
SNARK::encode,
SNARK::prove (the sat proof and the SPARK eval proof, tape seed 5), the host
verifier and the bincode size; with ``--nizk`` also the NIZK on the same
instance (prove, host verify, size).  For each k it prints one JSON line:
gen_s, encode_s, prove_s, verify_s, proof_bytes, the host's peak RSS so far,
the card's peak memory and each kernel entry's launches in encode and prove
(and the NIZK's numbers, with the instance digest's size, the time to
make it and the transcript's time to absorb it).  It writes no file.

    python3 scripts/torch_synthetic_profiler.py --k 10 12 14 16 18 --nizk
    python3 scripts/torch_synthetic_profiler.py --k 20 --nizk
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not measured"


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", required=True,
                    help="log2 of num_cons == num_vars, one point each")
    ap.add_argument("--inputs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--nizk", action="store_true",
                    help="also prove and verify the NIZK on the instance")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.device import resolve_device, synchronize
    from vpin_tpu_torch.snark import (NIZK, SNARK, NIZKGens, SNARKGens,
                                      instance_digest, produce_synthetic_r1cs,
                                      snark_encode)
    from vpin_tpu_torch.transcript import Transcript
    from vpin_tpu_torch.utils.bincode import serialize_nizk, serialize_snark

    dev = resolve_device(args.device)
    print(f"card: {card() if dev.type == 'cuda' else 'cpu'}", flush=True)
    if dev.type == "cuda":
        kernels.build()

    def timed(fn):
        """(result, seconds, launches by entry) of fn, the device drained."""
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        return (out, time.perf_counter() - t0,
                {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                 if v != before[k]})

    for k in args.k:
        n = 1 << k
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        inst, vars_ints, inputs = produce_synthetic_r1cs(
            n, n, args.inputs, args.seed, device=dev)
        t_gen = time.perf_counter() - t0
        gens = SNARKGens(inst.num_cons, inst.num_vars, inst.num_inputs,
                         max(m.nnz for m in (inst.A, inst.B, inst.C)))
        (comm, decomm), t_encode, l_encode = timed(
            lambda: snark_encode(inst, gens))
        print(f"2^{k}: gen {t_gen:.2f} s, encode {t_encode:.2f} s",
              flush=True)
        proof, t_prove, l_prove = timed(lambda: SNARK.prove(
            inst, comm, decomm, vars_ints, inputs, gens,
            Transcript(b"snark_example"), tape_seed=5))
        size = len(serialize_snark(proof))
        t0 = time.perf_counter()
        ok = proof.verify(comm, inst, inputs, Transcript(b"snark_example"),
                          gens)
        t_verify = time.perf_counter() - t0
        if not ok or size != proof.size():
            raise SystemExit(f"2^{k}: the SNARK did not verify")
        rec = {"k": k, "device": str(dev), "gen_s": t_gen,
               "encode_s": t_encode, "prove_s": t_prove,
               "verify_s": t_verify, "proof_bytes": size,
               "encode_launches": l_encode, "prove_launches": l_prove}
        if args.nizk:
            # the NIZK's transcript takes the instance digest whole: its
            # bincode and zlib, then the sponge's absorb of it
            t0 = time.perf_counter()
            digest = instance_digest(inst)
            t_digest = time.perf_counter() - t0
            t0 = time.perf_counter()
            Transcript(b"nizk_example").append_message(b"R1CSInstanceDigest",
                                                       digest)
            rec.update(digest_bytes=len(digest), digest_s=t_digest,
                       digest_absorb_s=time.perf_counter() - t0)
            ngens = NIZKGens(inst.num_cons, inst.num_vars, inst.num_inputs)
            nproof, t_np, l_np = timed(lambda: NIZK.prove(
                inst, vars_ints, inputs, ngens, Transcript(b"nizk_example"),
                tape_seed=5))
            t0 = time.perf_counter()
            nok = nproof.verify(inst, inputs, Transcript(b"nizk_example"),
                                ngens)
            t_nv = time.perf_counter() - t0
            if not nok:
                raise SystemExit(f"2^{k}: the NIZK did not verify")
            rec.update(nizk_prove_s=t_np, nizk_verify_s=t_nv,
                       nizk_bytes=len(serialize_nizk(nproof)),
                       nizk_launches=l_np)
        rec["peak_rss_gb"] = peak_rss_gb()
        rec["device_peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                 if dev.type == "cuda" else None)
        print(json.dumps(rec), flush=True)
        del inst, comm, decomm, proof
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
