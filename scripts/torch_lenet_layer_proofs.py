#!/usr/bin/env python3
"""Prove LeNet-5's per-layer witness slices with the PyTorch/CUDA port.

The reference proves its seven layer slices with `cargo run -- L$i`
(script.sh:204-212, main.rs:14-46); L2 and L4 have no mults, and L5 is the
2.08e7-constraint instance.  scripts/lenet_layer_proofs.py replays that
flow for vpin_tpu; this script replays it on the port, on the GPU unless
``--device cpu``, over a directory written by

    python -m vpin_tpu_torch.runner.cli lenet --export rust_files_lenet

(one sub-directory per layer, L1..L7), in the order given, each layer's
proofs with intra-proof checkpoints under ckpt_lenet_<L>/ (a killed run
resumes there).  By default each layer gets the full SNARK (the sat proof
and the SPARK eval proof of its matrices); ``--transparent`` proves the
sat proof alone.  It prints one JSON line per layer: proof bytes, prove and
verify ms, wall s, the host's peak RSS so far, the card's peak memory, and
the SPARK's product circuits with whether each kept only its leaves (lazy
layers, above spark/product_tree.LOW_MEMORY_ELEMS stacked leaves).  It
writes no file outside the checkpoint directories.  One H100 80GB proves
L1, L2, L3, L4, L6 and L7 with the full SNARK and L5 transparent:

    python3 scripts/torch_lenet_layer_proofs.py --layers L7,L6,L1,L2,L4,L3
    python3 scripts/torch_lenet_layer_proofs.py --layers L5 --transparent
"""

import argparse
import json
import os
import resource
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(REPO, "rust_files_lenet"))
    ap.add_argument("--layers", default="L7,L6,L1,L2,L4,L3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--transparent", action="store_true")
    ap.add_argument("--ckpt-base", default=REPO,
                    help="where the ckpt_lenet_<L>/ directories go")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from vpin_tpu_torch.device import resolve_device
    from vpin_tpu_torch.runner.proof_runner import prove_tag_dir
    from vpin_tpu_torch.spark import product_tree

    circuits = []
    init = product_tree.BatchedProductCircuits.__init__

    def watch(self, inputs):
        init(self, inputs)
        circuits.append(f"{self.K}x{self.n}"
                        + (" lazy" if self.low_memory else ""))

    product_tree.BatchedProductCircuits.__init__ = watch
    dev = resolve_device(args.device)
    for layer in (x.strip() for x in args.layers.split(",")):
        circuits.clear()
        d = os.path.join(args.dir, layer)
        print(f"\n===== {layer} ({d}) =====", flush=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        total = prove_tag_dir(
            d, tape_seed=args.seed, device=dev,
            full_snark=not args.transparent,
            skip_mult=layer in ("L2", "L4"),
            ckpt_dir=os.path.join(args.ckpt_base, f"ckpt_lenet_{layer}"))
        rec = {
            "layer": layer,
            "mode": "transparent" if args.transparent else "full_snark",
            "proof_bytes": total[0], "gen_ms": total[1], "ver_ms": total[2],
            "wall_s": time.perf_counter() - t0,
            "peak_rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6,
            "device_peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None),
            "lazy_layers": any(c.endswith(" lazy") for c in circuits),
            "product_circuits": list(circuits),
        }
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
