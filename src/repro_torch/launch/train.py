"""Training driver — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --smoke --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/run1 \
        [--ckpt-codec lossless] [--grad-bits 4] [--device cpu]

The reference's flags, plus ``--device`` (default ``cuda``; without a
card it raises, it never falls back to the CPU).  The step runs eagerly
(``launch.steps.make_train_step``); batches come from the background
``Prefetcher``, a ``StragglerMonitor`` skips a step whose fetch is late,
and with ``--ckpt-dir`` a ``TrainLoop`` checkpoints through
``CheckpointManager`` in the reference's layout (resuming from the
latest committed step).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointConfig, CheckpointManager
from ..configs.registry import ARCHITECTURES, get_config
from ..convert import train_state_from_arrays
from ..data.tokens import Prefetcher, TokenDataConfig
from ..device import resolve_device
from ..models import init_params
from ..optim.adamw import AdamWConfig, init_opt_state
from ..optim.compression import GradCompressionConfig, init_error_feedback
from ..runtime import StragglerMonitor, TrainLoop
from .steps import make_train_step

__all__ = ["build_state", "main"]


def build_state(cfg, opt_cfg, seed: int, grad_comp=None, *, device="cuda"):
    """``{"params": TransformerLM, "opt": AdamW state [+ "ef"]}`` drawn
    from ``seed`` on ``device``."""
    params = init_params(cfg, seed, device)
    opt = init_opt_state(params)
    if grad_comp is not None and grad_comp.enabled:
        opt["ef"] = init_error_feedback(params)
    return {"params": params, "opt": opt}


def main(argv=None) -> list[dict]:
    """Run the driver on ``argv`` (``sys.argv[1:]`` when None); returns the
    metrics log."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-codec", default=None,
                    choices=[None, "lossless", "q8", "q10", "q12"])
    ap.add_argument("--grad-bits", type=int, default=0,
                    help=">0 enables §7 dithered gradient compression")
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:1, cpu); no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps)
    grad_comp = (
        GradCompressionConfig(bits=args.grad_bits)
        if args.grad_bits else None
    )
    data_cfg = TokenDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
    )
    step_fn_raw = make_train_step(cfg, opt_cfg, remat=args.remat,
                                  grad_comp=grad_comp)

    prefetch = Prefetcher(data_cfg, start_step=0)
    straggler = StragglerMonitor()

    def step_fn(state, step):
        state = train_state_from_arrays(cfg, state, dev)  # after a restore
        t0 = time.time()
        got_step, batch = prefetch.get()
        fetch_s = time.time() - t0
        if straggler.should_skip(step, host=0, seconds=fetch_s):
            return state, {"skipped": 1.0}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, opt, metrics = step_fn_raw(state["params"], state["opt"],
                                           batch)
        return {"params": params, "opt": opt}, {
            k: float(v) for k, v in metrics.items()
        }

    try:
        state = build_state(cfg, opt_cfg, args.seed, grad_comp, device=dev)
        n_params = sum(p.numel() for p in state["params"].parameters())
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
              f"tokens/step={args.batch * args.seq} device={dev}",
              flush=True)

        if args.ckpt_dir:
            mgr = CheckpointManager(
                CheckpointConfig(args.ckpt_dir, codec=args.ckpt_codec),
                device=dev,
            )
            loop = TrainLoop(step_fn, mgr, save_every=args.ckpt_every)
            state = loop.run(state, args.steps)
            log = loop.metrics_log
        else:
            log = []
            for step in range(args.steps):
                state, m = step_fn(state, step)
                log.append(dict(m, step=step))
    finally:
        prefetch.close()
    for m in log:
        if m["step"] % args.log_every == 0 and "loss" in m:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"lr {m.get('lr', 0):.2e}", flush=True)
    losses = [m["loss"] for m in log if "loss" in m]
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})",
              flush=True)
    return log


if __name__ == "__main__":
    main()
