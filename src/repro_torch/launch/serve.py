"""Serving launcher: continuous batching over fresh seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --prompts "hello world" "the quick brown"

Serves every causal arch id of the registry (a vision model gets text
prompts alone); the encoder-only hubert-xlarge is refused.  Runs on the
card; ``--device cpu`` runs the plain PyTorch path instead.  Without
``--device cpu`` and without CUDA it raises.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--prompts", nargs="+", default=["hello world"])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import ByteTokenizer
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.causal:
        raise ValueError(f"{args.arch} is encoder-only: it has no "
                         f"autoregressive decode to serve")
    params = tfm.init_model(cfg, seed=0, device=device)

    tok = ByteTokenizer()
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_len=args.max_len)
    for p in args.prompts:
        eng.submit(tok.encode(p) % cfg.vocab, max_new=args.max_new)
    done = eng.run_until_idle()
    for r in sorted(done, key=lambda r: r.rid):
        print(f"[{r.rid}] {tok.decode(list(r.prompt))!r} -> "
              f"{tok.decode(r.out)!r}")
    return done


if __name__ == "__main__":
    main()
