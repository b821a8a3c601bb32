"""Command-line entry points of the port.

  python -m vpin_tpu_torch.runner.cli conv --filter 3 --size 32 --prove
  python -m vpin_tpu_torch.runner.cli conv --size 4 --device cpu --export DIR
  python -m vpin_tpu_torch.runner.cli cnn --version A [--prove]
  python -m vpin_tpu_torch.runner.cli lenet [--prove]
  python -m vpin_tpu_torch.runner.cli bsgs --m 3200000
  python -m vpin_tpu_torch.runner.cli prove --dir DIR --seed 11
  python -m vpin_tpu_torch.runner.cli mult-scale --mults 1000 --ckpt DIR
  python -m vpin_tpu_torch.runner.cli serve-conv --port 35000 [--export DIR]
  python -m vpin_tpu_torch.runner.cli client-conv --port 35000 --size 32

Every command runs on the GPU; ``--device cpu`` runs the plain PyTorch
versions.  ``conv``, ``cnn`` and ``lenet`` run client and server
in-process, record the witness trace, can export it as the reference's JSON
and can prove it (``lenet`` layer by layer, over its L1..L7 slices).
``cnn`` and ``lenet`` decrypt with the BSGS table of ``--bsgs-m`` entries,
read from ``--bsgs-cache`` when it holds one and written there otherwise;
``bsgs`` only builds that table.  ``prove`` proves a rust_files/<tag>
witness directory.  ``mult-scale`` proves a synthetic trace of
``--mults`` point mults (128-bit scalars, base points by host doublings);
with ``--ckpt`` the proof saves checkpoints there and a killed run resumes
from them.  ``serve-conv`` and ``client-conv`` run the conv workload as two
processes over the reference's socket protocol on 127.0.0.1, either end
interchangeable with vpin_tpu's.  Proofs are the full SNARK, with the SPARK eval proof
over the committed R1CS matrices; ``--transparent`` skips the eval proof and
has the verifier evaluate the public matrices itself.

The input image is the reference's MNIST image for the size, under
$VPIN_REFERENCE (default: nn/models.DEFAULT_REFERENCE_DIR), when it is
there, and a seeded random image otherwise; CNN and LeNet weights are the
reference's pretrained ones from the same directory when they are there,
and seeded stand-ins (nn/models.make_random_weights) otherwise.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np


def _make_image(size: int, seed: int) -> np.ndarray:
    """The reference's MNIST image for this size when the reference
    directory holds it, a seeded random image otherwise."""
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


def _table(args, device):
    from ..nn.bsgs import BsgsTable
    t0 = time.perf_counter()
    table = BsgsTable.build(m=args.bsgs_m, cache_path=args.bsgs_cache,
                            device=device)
    print(f"BSGS table: m={table.m} in {time.perf_counter() - t0:.2f} s")
    return table


def _report(res, device) -> None:
    print(f"Server: Number of EC point multiplications: {res.num_mults}")
    print(f"Server: Number of EC point additions: {res.num_adds}")
    print(f"Logits: {res.logits.tolist()}")
    print("Times (s): " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in res.timings.items())
          + f" on {device}")
    print(f"Giant-step rounds per decryption: {res.decrypt_rounds}")


def _cnn_weights(args):
    """FC weights for ``cnn``: None (the pretrained ones, else stand-ins)
    at the model's own size; otherwise seeded stand-ins with as many FC1
    inputs as the pooled image has pixels, uniform in +-``--weight-scale``
    (the reference CLI's reduced runs) or in the stand-ins' +-0.5."""
    from ..nn.models import CNN_CONFIGS, make_random_weights
    fc1_in, fc1_out, k, s = CNN_CONFIGS[args.version]
    n_in = ((args.size - k) // s + 1) ** 2
    if args.weight_scale is None and n_in == fc1_in:
        return None
    scale = 0.5 if args.weight_scale is None else args.weight_scale
    return make_random_weights(n_in, fc1_out, seed=args.seed, scale=scale)


def cmd_cnn(args) -> int:
    from ..device import resolve_device
    from ..nn.elgamal import KeyPair
    from ..nn.models import run_cnn_workload
    from .proof_runner import prove_trace

    device = resolve_device(args.device)
    key = KeyPair.generate(random.Random(args.seed), device=device)
    table = _table(args, device)
    img = _make_image(args.size, args.seed)
    res = run_cnn_workload(args.version, img, key, table,
                           weights=_cnn_weights(args),
                           rng=random.Random(args.seed),
                           max_steps=args.max_steps)
    _report(res, device)
    if args.export:
        res.trace.export_json(args.export)
        print(f"Witness JSON exported to {args.export}")
    if args.prove:
        prove_trace(res.trace, tape_seed=args.seed, device=device,
                    full_snark=not args.transparent)
    return 0


def cmd_lenet(args) -> int:
    from ..device import resolve_device
    from ..nn.elgamal import KeyPair
    from ..nn.models import run_lenet_workload
    from .proof_runner import prove_trace

    device = resolve_device(args.device)
    key = KeyPair.generate(random.Random(args.seed), device=device)
    table = _table(args, device)
    img = _make_image(args.size, args.seed)
    if img.shape[0] < 32:  # the reference pads MNIST 28x28 to 32x32
        pad = (32 - img.shape[0]) // 2
        img = np.pad(img, ((pad, 32 - img.shape[0] - pad),) * 2)
    res = run_lenet_workload(img, key, table, rng=random.Random(args.seed),
                             num_kernels=tuple(args.kernels),
                             max_steps=args.max_steps)
    _report(res, device)
    for name, (msl, asl) in res.layer_slices.items():
        print(f"  {name}: mults {msl} adds {asl}")
    if args.export:
        fin = res.trace.finalize()
        for name, (msl, asl) in res.layer_slices.items():
            res.trace.export_json(f"{args.export}/{name}", mult_slice=msl,
                                  add_slice=asl, _finalized=fin)
        print(f"Witness JSON exported to {args.export}/L1..L7")
    if args.prove:
        for name, (msl, asl) in res.layer_slices.items():
            print(f"\n=== layer {name} ===")
            prove_trace(res.trace, tape_seed=args.seed, mult_slice=msl,
                        add_slice=asl, device=device,
                        full_snark=not args.transparent)
    return 0


def cmd_bsgs(args) -> int:
    from ..device import resolve_device
    from ..nn.bsgs import BsgsTable
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    table = BsgsTable.build(m=args.m, cache_path=args.cache, device=device)
    print(f"BSGS table built: m={table.m} entries={len(table.keys_sorted)} "
          f"in {time.perf_counter() - t0:.1f} s on {device}")
    return 0


def cmd_prove(args) -> int:
    from ..device import resolve_device
    from .proof_runner import prove_tag_dir
    prove_tag_dir(args.dir, tape_seed=args.seed,
                  device=resolve_device(args.device),
                  full_snark=not args.transparent)
    return 0


def cmd_mult_scale(args) -> int:
    """A synthetic point-mult proof at scale (the LeNet-L5 path's gadget;
    reference point_mult.rs:61-62)."""
    from ..curve.host_ec import E2_G_HOST, E2_ORDER
    from ..device import resolve_device
    from .proof_runner import prove_point_mult

    device = resolve_device(args.device)
    rng = random.Random(args.seed)
    n = args.mults
    print(f"Generating {n} random point-mults (n=128-bit scalars)...")
    t0 = time.perf_counter()
    scalars = [rng.randrange(1, 1 << 128) for _ in range(n)]
    P = rng.randrange(1, E2_ORDER) * E2_G_HOST
    px, py = [], []
    for _ in range(n):             # distinct base points by host doublings
        px.append(P.x)
        py.append(P.y)
        P = P + P
    print(f"trace ready in {time.perf_counter() - t0:.1f} s")
    prove_point_mult(scalars, px, py, tape_seed=args.seed, device=device,
                     full_snark=not args.transparent, ckpt_dir=args.ckpt)
    return 0


def cmd_serve_conv(args) -> int:
    from ..nn.socket_runner import server_main
    result = server_main(args.port, filter_size=args.filter,
                         export_dir=args.export, device=args.device)
    print(f"Server: Number of EC point multiplications: {result['num_mults']}")
    print(f"Server: Number of EC point additions: {result['num_adds']}")
    return 0


def cmd_client_conv(args) -> int:
    from ..nn.socket_runner import client_main
    img = _make_image(args.size, args.seed)
    t0 = time.perf_counter()
    result = client_main(args.port, img, seed=args.seed, device=args.device)
    print(f"Client: server reported {result}")
    print(f"Client: request wall time "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms on {args.device}")
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

    for name, help_ in (("cnn", "CNN A-E workload (E2)"),
                        ("lenet", "LeNet-5 workload (E4)")):
        c = sub.add_parser(name, help=help_)
        if name == "cnn":
            c.add_argument("--version", type=str, default="A",
                           choices=list("ABCDE"))
            c.add_argument("--size", type=int, default=32)
            c.add_argument("--weight-scale", type=float, default=None,
                           help="use random weights of this magnitude "
                                "(reduced runs)")
        else:
            c.add_argument("--size", type=int, default=28)
            c.add_argument("--kernels", type=int, nargs=3,
                           default=(6, 16, 120),
                           help="kernel counts per conv stage (reduced runs)")
        c.add_argument("--seed", type=int, default=0)
        c.add_argument("--bsgs-m", type=int, default=3_200_000)
        c.add_argument("--bsgs-cache", type=str, default=".bsgs_table.pkl")
        c.add_argument("--export", type=str, default=None)
        c.add_argument("--prove", action="store_true")
        c.add_argument("--transparent", action="store_true",
                       help="skip the R1CS eval proof (the verifier "
                            "evaluates the public matrices)")
        c.add_argument("--max-steps", type=int, default=None)
        c.add_argument("--device", type=str, default="cuda")
        c.set_defaults(fn=cmd_cnn if name == "cnn" else cmd_lenet)

    c = sub.add_parser("bsgs", help="build the BSGS decryption table (E1)")
    c.add_argument("--m", type=int, default=3_200_000)
    c.add_argument("--cache", type=str, default=".bsgs_table.pkl")
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_bsgs)

    c = sub.add_parser("prove", help="prove a rust_files/<tag> witness dir")
    c.add_argument("--dir", type=str, required=True)
    c.add_argument("--seed", type=int, default=None)
    c.add_argument("--transparent", action="store_true",
                   help="skip the R1CS eval proof (the verifier evaluates "
                        "the public matrices)")
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_prove)

    c = sub.add_parser("serve-conv",
                       help="socket-mode conv server (two-process)")
    c.add_argument("--port", type=int, default=35000)
    c.add_argument("--filter", type=int, default=3, choices=[3, 5, 7])
    c.add_argument("--export", type=str, default=None)
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_serve_conv)

    c = sub.add_parser("client-conv",
                       help="socket-mode conv client (two-process)")
    c.add_argument("--port", type=int, default=35000)
    c.add_argument("--size", type=int, default=32)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_client_conv)

    c = sub.add_parser("mult-scale",
                       help="synthetic point-mult proof at scale")
    c.add_argument("--mults", type=int, default=1000)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--transparent", action="store_true",
                   help="skip the R1CS eval proof (the verifier evaluates "
                        "the public matrices)")
    c.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint dir: a killed proof resumes from it")
    c.add_argument("--device", type=str, default="cuda")
    c.set_defaults(fn=cmd_mult_scale)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
