"""Batched serving driver: prefill a batch of prompts, then decode — the
port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --smoke --device cpu --temperature 0

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu --temperature 0

Prefill goes through ``make_prefill_step(cfg, use_flash=True)``, so the
prompt runs the hand-written kernels on a card and their plain versions on
the CPU: the flash kernel (K7) for the dense GQA archs' attention, the
WKV6 kernel (K8) for RWKV6's recurrence.  Decode steps follow one token at
a time.  Sampling draws from an explicit ``torch.Generator``;
``--temperature 0`` is greedy.  The device defaults to ``cuda`` and raises
without a card.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.registry import ARCHITECTURES, get_config
from ..device import resolve_device
from ..models import init_params
from .steps import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sample(logits, temperature: float, gen: torch.Generator):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.argmax(logits, dim=-1)


def main(argv: list[str] | None = None) -> torch.Tensor:
    """Run the driver; returns the generated token ids (B, gen)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = init_params(cfg, seed=args.seed, device=dev)

    max_len = args.prompt_len + args.gen
    host = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=host
    ).to(dev)
    fe = None
    if cfg.frontend is not None and cfg.n_frontend_tokens:
        fe = torch.randn(
            (args.batch, cfg.n_frontend_tokens, cfg.d_model), generator=host
        ).to(dev, getattr(torch, cfg.dtype))
    sample_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)

    prefill_step = make_prefill_step(cfg, use_flash=True)
    decode_step = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompts, fe, max_len=max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits, dim=-1)
    out = [tokens]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, cache = decode_step(params, tokens, cache)
        tokens = _sample(logits, args.temperature, sample_gen)
        out.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.stack(out, 1)
    toks_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"arch={cfg.name} device={dev} prefill({args.batch}x"
          f"{args.prompt_len}) {t_prefill:.2f}s; decode {args.gen - 1} steps "
          f"{t_decode:.2f}s = {toks_s:.1f} tok/s")
    print("sample token ids:", gen[0, :16].tolist())
    return gen


if __name__ == "__main__":
    main()
