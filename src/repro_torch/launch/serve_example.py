"""Batched serving example: prefill + greedy decode with a KV/state cache.
The port of ``examples/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve_example \
        --arch gemma2-27b --tokens 16 [--device cpu]

Uses the reduced (SMOKE) config of the chosen architecture (any arch of
the registry; gemma2-27b by default), so it runs on one CPU as well as on
the card; ``repro_torch.launch.serve`` runs the full configs.  The
weights are the port's seeded init with seed 0 (drawn on the CPU, the
same on every device), the prompt comes from a CPU generator with seed 1
and, for the encdec arch (whisper), the frames from one with seed 2, as
the JAX example uses keys 0, 1 and 2.  Without ``--device`` it runs on
CUDA (and raises where there is no card).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import audio_frames
from repro_torch.models import decode_step, init_params, prefill


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Prefill and decode; returns the (batch, tokens) greedy tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma2-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(0, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    frames = None
    if cfg.family == "encdec":
        frames = audio_frames(cfg, args.batch).to(dev)

    with torch.inference_mode():
        t0 = time.monotonic()
        logits, cache = prefill(params, prompt, cfg,
                                max_seq=args.prompt_len + args.tokens,
                                frames=frames)
        print(f"[{cfg.name}] prefill {args.batch}x{args.prompt_len} "
              f"in {time.monotonic() - t0:.2f}s on {dev}; cache "
              f"index={int(cache['index'])}")

        out = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
        t0 = time.monotonic()
        for _ in range(args.tokens - 1):
            logits, cache = decode_step(params, cache, out[-1], cfg)
            out.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.monotonic() - t0
    seqs = torch.cat(out, dim=1)
    print(f"decoded {args.tokens} tokens/seq in {dt:.2f}s "
          f"({args.batch * args.tokens / max(dt, 1e-9):.1f} tok/s total)")
    print("first sequence:", seqs[0].tolist())
    return seqs


if __name__ == "__main__":
    main()
