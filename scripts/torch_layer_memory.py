#!/usr/bin/env python3
"""Card memory and time of LeNet-5 layer proofs, stored against lazy
product-tree layers, with the peak of each prover stage.

Proves the layers of a directory written by

    python -m vpin_tpu_torch.runner.cli lenet --export rust_files_lenet

once per mode, in the order given, and requires every mode's proof bytes
to be equal.  Modes: ``stored`` raises spark/product_tree.LOW_MEMORY_ELEMS
above every layer's leaves, so that each product circuit keeps its whole
layer stack; ``lazy`` keeps the module's default, under which circuits
above it recompute each layer from the leaves.  With ``--spans`` the
prover's stages (the SPARK encode, the witness commit, the sat proof's
sumchecks, the product circuits, the hashed leaves, the R1CS reductions,
the Hyrax commits and openings) are wrapped, and each one's calls, host
seconds and card peak are printed: the peak of a stage is the most the
allocator held while it ran, nested stages included.

    python3 scripts/torch_layer_memory.py --layers L6 --modes stored,lazy,lazy,stored
    python3 scripts/torch_layer_memory.py --layers L7 --modes lazy --spans
    python3 scripts/torch_layer_memory.py --layers L5 --modes lazy --transparent --spans

``--transparent`` proves the sat proof alone (no SPARK, so the modes do
not differ), as L5 is proven on one card.

It prints the card's name and power limit, one JSON line per proof run
and, with ``--spans``, one table per run.  It writes no file.
"""

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

#: the stages --spans wraps: module, then a function or Class.method
STAGES = [
    ("gadgets.point_addition", "point_addition_gadget"),
    ("gadgets.point_mult", "point_mult_gadget"),
    ("snark.cp_snark", "snark_encode"),
    ("snark.cp_snark", "cp_commit_witness"),
    ("snark.cp_snark", "cp_snark_prove"),
    ("snark.cp_snark", "cp_snark_verify"),
    ("snark.r1csproof", "_r1cs_prove_core"),
    ("snark.r1csproof", "poly_commit"),
    ("snark.r1csproof", "PolyEvalProof.prove"),
    ("snark.r1cs", "SparseMat._reduce_buckets"),
    ("snark.r1cs", "SparseMat.evaluate"),
    ("sumcheck.sumcheck", "ZKSumcheckInstanceProof._prove_rounds"),
    ("spark.sparse_mlpoly", "MultiSparseMatPolynomialAsDense.__init__"),
    ("spark.sparse_mlpoly", "Derefs.__init__"),
    ("spark.sparse_mlpoly", "Layers.__init__"),
    ("spark.sparse_mlpoly", "ProductLayerProof.prove"),
    ("spark.sparse_mlpoly", "HashLayerProof.prove"),
    ("spark.product_tree", "BatchedProductCircuits.__init__"),
    ("spark.product_tree", "ProductCircuitEvalProofBatched.prove"),
    ("spark.product_tree", "_Tables.round_evals"),
    ("spark.product_tree", "_Tables.bind"),
]


class PeakSpans:
    """Wraps STAGES so that each records its calls, host seconds and the
    card's peak allocation while it ran (nested stages included).  Nested
    peaks are kept apart by resetting the allocator's peak at each entry
    and exit and folding it into the enclosing stage's running maximum."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.stack = []
        self.rows = {}
        self.undo = []
        self.missing = []

    def _peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.dev)

    def _reset(self) -> None:
        self.torch.cuda.reset_peak_memory_stats(self.dev)

    def enter(self) -> None:
        if self.stack:
            self.stack[-1] = max(self.stack[-1], self._peak())
        self._reset()
        self.stack.append(self._peak())

    def leave(self) -> int:
        peak = max(self.stack.pop(), self._peak())
        if self.stack:
            self.stack[-1] = max(self.stack[-1], peak)
        self._reset()
        return peak

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            self.enter()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                peak = self.leave()
                row = self.rows.setdefault(name, [0, 0.0, 0])
                row[0] += 1
                row[1] += time.perf_counter() - t
                row[2] = max(row[2], peak)
        return wrapper

    def install(self) -> None:
        pkg = "vpin_tpu_torch"
        for mod_name, qual in STAGES:
            mod = importlib.import_module(f"{pkg}.{mod_name}")
            owner, _, attr = qual.rpartition(".")
            holder = getattr(mod, owner, None) if owner else mod
            if holder is None or not hasattr(holder, attr):
                self.missing.append(f"{mod_name}:{qual}")
                continue
            raw = inspect.getattr_static(holder, attr)
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            new = self._wrap(qual, fn)
            setattr(holder, attr,
                    staticmethod(new) if isinstance(raw, staticmethod)
                    else new)
            self.undo.append((holder, attr, raw))
            if owner:
                continue
            # module functions imported by name elsewhere in the package
            for other in list(sys.modules.values()):
                if (other is not None and other is not mod
                        and getattr(other, "__name__", "").startswith(pkg)
                        and getattr(other, attr, None) is fn):
                    setattr(other, attr, new)
                    self.undo.append((other, attr, fn))

    def remove(self) -> None:
        for holder, attr, raw in reversed(self.undo):
            setattr(holder, attr, raw)
        self.undo = []

    def table(self) -> str:
        out = ["| stage | calls | host s | card peak GB |",
               "| --- | --- | --- | --- |"]
        for name, (calls, secs, peak) in sorted(
                self.rows.items(), key=lambda kv: -kv[1][2]):
            out.append(f"| {name} | {calls} | {secs:.3f} | {peak / 1e9:.3f} |")
        return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(REPO, "rust_files_lenet"))
    ap.add_argument("--layers", default="L6")
    ap.add_argument("--modes", default="stored,lazy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spans", action="store_true")
    ap.add_argument("--transparent", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_layer_memory: no CUDA device", file=sys.stderr)
        return 1
    from vpin_tpu_torch.device import resolve_device
    from vpin_tpu_torch.runner import proof_runner as pr
    from vpin_tpu_torch.spark import product_tree as pt
    from vpin_tpu_torch.spark import sparse_mlpoly as sm

    dev = resolve_device(args.device)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    default = getattr(pt, "LOW_MEMORY_ELEMS", None)
    limits = {"stored": 1 << 62, "lazy": default}
    for layer in (x.strip() for x in args.layers.split(",")):
        blobs = None
        for mode in (m.strip() for m in args.modes.split(",")):
            if default is not None:
                pt.LOW_MEMORY_ELEMS = limits[mode]
            elif mode != "stored":
                raise SystemExit("this tree has no lazy product layers")
            engaged = []
            init = pt.BatchedProductCircuits.__init__

            def watch(self, *a, _init=init, **k):
                _init(self, *a, **k)
                engaged.append(((self.K, self.n),
                                bool(getattr(self, "low_memory", False))))
            pt.BatchedProductCircuits.__init__ = watch
            spans = PeakSpans(torch, dev)
            if args.spans:
                spans.install()
            pr.RECORD = []
            torch.cuda.synchronize(dev)
            spans.enter()
            t0 = time.perf_counter()
            try:
                total = pr.prove_tag_dir(
                    os.path.join(args.dir, layer), tape_seed=args.seed,
                    device=dev, full_snark=not args.transparent,
                    skip_mult=layer in ("L2", "L4"))
                got = [b for _, b in pr.RECORD]
            finally:
                wall = time.perf_counter() - t0
                peak = spans.leave()
                spans.remove()
                pt.BatchedProductCircuits.__init__ = init
                pr.RECORD = None
            if blobs is None:
                blobs = got
            if got != blobs:
                raise SystemExit(f"{layer} {mode}: proof bytes differ from "
                                 "the first mode's")
            print(json.dumps({
                "layer": layer, "mode": mode,
                "proof": "transparent" if args.transparent else "full_snark",
                "low_memory_elems": pt.LOW_MEMORY_ELEMS if default else None,
                "leaf_chunk": getattr(sm, "_LEAF_CHUNK", None),
                "proof_bytes": total[0], "prove_ms": total[1],
                "verify_ms": total[2], "wall_s": round(wall, 3),
                "device_peak_gb": peak / 1e9,
                "circuits": [f"{k}x{n}{' lazy' if lazy else ''}"
                             for (k, n), lazy in engaged],
                "byte_equal_to_first": True}), flush=True)
            if args.spans:
                if spans.missing:
                    print("not on this tree: " + ", ".join(spans.missing))
                print(spans.table(), flush=True)
        if default is not None:
            pt.LOW_MEMORY_ELEMS = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
