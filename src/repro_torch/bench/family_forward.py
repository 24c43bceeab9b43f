"""Time one model family's forward on the card.

A full-width config cut to ``--layers`` (grok-1-314b at 2 of its 64, as
``chip_smoke.py``'s families phase runs it), weights from seed 0, bf16,
tokens from seed 1: one warm-up, then the median of ``--runs`` synced
forwards, and a checksum of the last logits.  It imports only what every
tree of the port since the families were ported has, so that it can time
another tree: ``PYTHONPATH=<tree>/src python3
src/repro_torch/bench/family_forward.py --label parent`` times the tree
at ``<tree>`` (parent against change, in one call).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.registry import get_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="grok-1-314b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    api = get_model(cfg)
    params = api.init(0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    if api.needs_ctx:
        batch["ctx"] = torch.randn(
            (args.batch, cfg.n_ctx_tokens, cfg.d_model), generator=gen,
            device="cuda").to(cfg.dtype)
    walls = []
    with torch.no_grad():
        for _ in range(args.runs + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = api.forward(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    timed = sorted(walls[1:])
    print(json.dumps({
        "label": args.label, "arch": cfg.name, "layers": cfg.n_layers,
        "batch": args.batch, "seq": args.seq,
        "median_s": timed[len(timed) // 2], "walls_s": walls[1:],
        "tokens_per_s": args.batch * args.seq / timed[len(timed) // 2],
        "logits_sha256": hashlib.sha256(
            out.float().cpu().numpy().tobytes()).hexdigest()}), flush=True)


if __name__ == "__main__":
    main()
