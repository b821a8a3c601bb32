"""Command-line entry points of the port.

  python -m vpin_tpu_torch.runner.cli conv --filter 3 --size 32 --prove
  python -m vpin_tpu_torch.runner.cli conv --size 4 --device cpu --export DIR
  python -m vpin_tpu_torch.runner.cli prove --dir DIR --seed 11

``conv`` runs client and server in-process on the GPU (``--device cpu``
runs the plain PyTorch versions), records the witness trace, can export it
as the reference's JSON and can prove it.  ``prove`` proves a
rust_files/<tag> witness directory.  Both prove the full SNARK, with the
SPARK eval proof over the committed R1CS matrices; ``--transparent`` skips
the eval proof and has the verifier evaluate the public matrices itself.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np


def _make_image(size: int, seed: int) -> np.ndarray:
    """The reference's MNIST image for this size when $VPIN_REFERENCE holds
    it, a seeded random image otherwise."""
    from ..nn.models import load_reference_image
    img = load_reference_image(size)
    if img is not None:
        print(f"Using reference MNIST image image_mnist_{size}_{size}.npy")
        return img
    return np.random.RandomState(seed).uniform(0.0, 1.0, (size, size)).astype(
        np.float32)


def cmd_conv(args) -> int:
    from ..device import resolve_device
    from ..nn.elgamal import KeyPair
    from ..nn.models import run_conv_workload
    from .proof_runner import prove_trace

    device = resolve_device(args.device)
    key = KeyPair.generate(random.Random(args.seed), device=device)
    img = _make_image(args.size, args.seed)
    t0 = time.perf_counter()
    res = run_conv_workload(img, args.filter, key, random.Random(args.seed))
    print(f"Server: Number of EC point multiplications: {res.num_mults}")
    print(f"Server: Number of EC point additions: {res.num_adds}")
    print(f"Inference time: {time.perf_counter() - t0:.2f} s on {device}")
    if args.export:
        res.trace.export_json(args.export)
        print(f"Witness JSON exported to {args.export}")
    if args.prove:
        prove_trace(res.trace, tape_seed=args.seed, device=device,
                    full_snark=not args.transparent)
    return 0


def cmd_prove(args) -> int:
    from ..device import resolve_device
    from .proof_runner import prove_tag_dir
    prove_tag_dir(args.dir, tape_seed=args.seed,
                  device=resolve_device(args.device),
                  full_snark=not args.transparent)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vpin-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("conv", help="single conv layer workload (E3)")
    c.add_argument("--filter", type=int, default=3, choices=[3, 5, 7])
    c.add_argument("--size", type=int, default=32)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--export", type=str, default=None)
    c.add_argument("--prove", action="store_true")
    c.add_argument("--transparent", action="store_true",
                   help="skip the R1CS eval proof (the verifier evaluates "
                        "the public matrices)")
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_conv)

    c = sub.add_parser("prove", help="prove a rust_files/<tag> witness dir")
    c.add_argument("--dir", type=str, required=True)
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--transparent", action="store_true",
                   help="skip the R1CS eval proof (the verifier evaluates "
                        "the public matrices)")
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_prove)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
