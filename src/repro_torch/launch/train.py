"""Training launcher.  Counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      --smoke --steps 50 --ckpt runs/train_demo

Any arch id of the registry works (--smoke selects the reduced config).
Runs on the card; ``--device cpu`` runs the plain PyTorch path instead,
and without it and without CUDA it raises.  The loop checkpoints
periodically, drains on SIGTERM, resumes automatically, and traces every
step into the Akita task DB (--trace-db) for Daisen export.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--moments-dtype", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--ckpt", default="runs/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--trace-db", default=None)
    ap.add_argument("--no-resume", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.tracing import TracingDomain
    from repro_torch.data import DataPipeline
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainHParams

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")
    data = DataPipeline(cfg, batch=args.batch, seq=args.seq)
    dom = TracingDomain("train")
    db = None
    if args.trace_db:
        from repro_torch.core.tracers import DBTracer
        db = dom.attach(DBTracer(args.trace_db))
    _, _, hist = train(
        cfg, data,
        LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=args.ckpt, log_every=10),
        TrainHParams(lr=args.lr, micro_batches=args.micro_batches,
                     moments_dtype=args.moments_dtype),
        domain=dom, resume=not args.no_resume, device=device)
    if db:
        db.close()
    print(f"done: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({len(hist)} steps this process)")
    return hist


if __name__ == "__main__":
    main()
