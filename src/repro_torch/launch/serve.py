"""Serving entry point of the port: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        [--smoke] --batch 4 --prompt-len 16 --tokens 32 [--device cpu]

Takes every arch of the registry.  Runs on CUDA unless ``--device cpu``
is given (and raises where there is no card).  Parameters come from the
port's init with a generator of seed 0 on the run's device (on the card
the draws are made there: a 27 B model drawn on the CPU would take
minutes), the prompt from a CPU generator with seed 1 and, for the encdec
arch (whisper), the stub frontend's frames -- standard normals of (batch,
enc_seq, d_model) in bf16 -- from a CPU generator with seed 2, as the JAX
entry point uses keys 0, 1 and 2.  No positions are passed: the
model counts them from the cache's index (three equal streams for an
M-RoPE model, text).  Built from the :mod:`repro_torch.serve.step`
factories, so it times the code path that ships.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.step import make_prefill_step, make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def audio_frames(cfg, batch: int, seed: int = 2) -> torch.Tensor:
    """The stub audio frontend's frame embeddings: standard normals of
    (batch, enc_seq, d_model) drawn in float32 on the CPU from a generator
    of ``seed``, rounded to bf16."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.enc_seq, cfg.d_model),
                       generator=g).to(torch.bfloat16)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = audio_frames(cfg, args.batch).to(dev)

    prefill_step = make_prefill_step(cfg, max_seq=args.prompt_len + args.tokens)
    serve_step = make_serve_step(cfg)

    t0 = time.monotonic()
    logits, cache = prefill_step(params, batch)
    _sync(dev)
    print(f"prefill: {time.monotonic() - t0:.2f}s on {dev}")

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.monotonic()
    for _ in range(args.tokens - 1):
        logits, cache = serve_step(params, cache, {"tokens": tok})
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    dt = time.monotonic() - t0
    print(f"decode: {args.tokens - 1} steps in {dt:.2f}s "
          f"({args.batch * (args.tokens - 1) / max(dt, 1e-9):.1f} tok/s)")


if __name__ == "__main__":
    main()
