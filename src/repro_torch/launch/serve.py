"""Serving launcher: the greedy `Engine` over one card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
      --smoke --device cpu

Serves any of the ten architectures' full config (``--smoke``: its small
one) with weights drawn from seed 0, on the card unless ``--device cpu``.
The vision and audio families get a per-slot ctx drawn from
``np.random.default_rng(0)``, as the reference's launcher draws it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry as cfgs
from repro_torch.core.platform import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(cfgs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="serve the architecture's small config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = (cfgs.get_smoke if args.smoke else cfgs.get_config)(args.arch)
    dev = resolve_device(args.device)
    api = get_model(cfg)
    params = api.init(0, device=dev)
    ctx = None
    if api.needs_ctx:
        ctx = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (args.slots, cfg.n_ctx_tokens, cfg.d_model)).astype(
                np.float32)).to(dev)
    eng = Engine(api, params, n_slots=args.slots, max_seq=args.max_seq,
                 ctx=ctx, device=dev)
    rng = np.random.default_rng(1)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=list(rng.integers(1, cfg.vocab, 4)),
                           max_new=8))
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"[launch.serve] {cfg.name} on {dev}: {len(done)} requests, "
          f"{toks} tokens, {toks / dt:.1f} tok/s")
    return done


if __name__ == "__main__":
    main()
