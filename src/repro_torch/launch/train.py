"""Training launcher (port of ``repro.launch.train``): ``--arch <id>`` +
the fault-tolerant loop, with the reference's flags, defaults and output
line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 200 --batch 8 --seq-len 128 --reduced --ckpt-dir ckpt

The device is the runtime profile's: ``$REPRO_RUNTIME_PROFILE`` (e.g.
``cpu-dev`` for the CPU), else the card, raising where there is none (the
serving CLI has no device flag either).  ``--reduced`` is the reference's
``store_true`` flag with ``default=True``, so it cannot be turned off
and the full configs are not reachable from here (ROADMAP queue C, C12);
a full-width model trains from Python through ``launch.steps`` or
``train.train``.  The GNN family has no launcher here, as in the
reference.
"""

from __future__ import annotations

import argparse
from functools import partial

import torch

from repro_torch.configs import get
from repro_torch.data import lm_data, recsys_data
from repro_torch.device import resolve_device
from repro_torch.runtime import profile as rtprofile
from repro_torch.train import OptConfig, TrainConfig, train
from repro_torch.train.fault_tolerance import run_with_retries


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--max-failures", type=int, default=3)
    args = ap.parse_args(argv)

    rtprofile.apply(rtprofile.resolve())
    dev = resolve_device(None)
    mod = get(args.arch)
    schedule = getattr(mod, "OPTIMIZER_SCHEDULE", "cosine")
    opt_cfg = OptConfig(lr=args.lr, schedule=schedule,
                        warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       microbatches=args.microbatches)
    gen = torch.Generator(device=dev).manual_seed(0)

    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as TF

        cfg = mod.reduced_config() if args.reduced else mod.config()
        params = TF.init_params(gen, cfg, device=dev)
        loss_fn = partial(TF.lm_loss, cfg=cfg)
        data = lm_data.batch_iterator(args.batch, args.seq_len, cfg.vocab,
                                      device=dev)
    elif mod.FAMILY == "recsys":
        from repro_torch.models.recsys import models as RM

        cfg = mod.reduced_config() if args.reduced else mod.config()
        params = RM.init_params(gen, cfg, device=dev)
        loss_fn = partial(RM.bce_loss, cfg=cfg)
        data = recsys_data.batch_iterator(
            args.batch, cfg.n_dense, cfg.vocab_sizes, seq_len=cfg.seq_len,
            device=dev,
        )
    else:
        raise SystemExit(f"use examples/ for family {mod.FAMILY!r}")

    def job():
        return train(lambda p, b: loss_fn(p, b), params, data, opt_cfg, tcfg)

    # restart-from-checkpoint is inside train(); retries make crashes resumable
    _params, _opt, history = run_with_retries(
        job, restore=lambda: None, max_failures=args.max_failures
    )
    print(f"[launch/train] {args.arch}: final loss {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
