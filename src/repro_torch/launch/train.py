"""Training launcher: the fault-tolerant `Trainer` on one card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --smoke --steps 20 --device cpu

Trains any of the ten architectures' full config (``--smoke``: its small
one) with weights drawn from seed 0 on batches of the synthetic stream
(`repro_torch.data.synthetic`), on the card unless ``--device cpu``;
with ``--ckpt-dir`` it resumes from the newest checkpoint there and
seeks the stream to that step.  The vision and audio families get one
ctx drawn from ``np.random.default_rng(0)``, the same for every batch,
as `launch.serve` draws its per-slot ctx (the reference's launcher gives
them none and cannot train them).  The reference's mesh and sharding
rules have no counterpart on one card.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry as cfgs
from repro_torch.core.platform import resolve_device
from repro_torch.data.synthetic import DataConfig, Stream
from repro_torch.models.registry import count_params, get_model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def with_ctx(stream, ctx):
    """Each batch of ``stream`` with ``ctx`` beside its tokens."""
    for batch in stream:
        yield dict(batch, ctx=ctx)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(cfgs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="train the architecture's small config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = (cfgs.get_smoke if args.smoke else cfgs.get_config)(args.arch)
    dev = resolve_device(args.device)
    api = get_model(cfg)
    trainer = Trainer(
        api, AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps),
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=max(10, args.steps // 2),
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      compress_grads=args.compress_grads),
        device=dev)
    print(f"[launch.train] {cfg.name}: "
          f"{count_params(trainer.params) / 1e6:.1f}M params on {dev}")
    trainer.maybe_resume()
    stream = Stream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch))
    stream.seek(trainer.step_idx)
    batches = stream
    if api.needs_ctx:
        batches = with_ctx(stream, np.random.default_rng(0).standard_normal(
            (args.batch, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32))
    res = trainer.fit(batches)
    if res["losses"]:
        print(f"[launch.train] finished at step {res['final_step']}; "
              f"loss {res['losses'][0]:.3f} -> {res['losses'][-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
