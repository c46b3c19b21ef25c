"""The program under test, reached through its public entry points: its
model built on the meta device and loaded with the benchmark's weights,
and the seeded inputs both sides are handed."""
from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, List, Tuple

import torch

from .core import model_config, scaled, sub_seed
from .weights import make_weights


class Cell:
    """What every kind's ``Bench`` shares: the cell's scaled files, the
    port's config, the reference module and the seeded weights."""

    def __init__(self, cell, seed: int, device: str, scale: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.config = scaled(cell.config, scale)
        self.m = self.config["model"]
        self.t = scaled(cell.traffic, scale)
        self.cfg = model_config(self.config)
        self.ref = importlib.import_module(
            f"reference.{self.config['reference']}")
        self.vocab = int(self.config["token_vocab"])

    def weights(self) -> Dict[str, torch.Tensor]:
        """The weights, made again the same from the seed on each call."""
        return make_weights(self.ref.leaves(self.m), self.config["init"],
                            sub_seed(self.seed, "weights"), self.device)

    def free(self, *names: str) -> None:
        """Drop the program's state held under ``names``."""
        for n in names:
            delattr(self, n)
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()


def load_model(cfg, weights: Dict[str, torch.Tensor],
               leaves: List[Tuple[str, Tuple[int, ...], torch.dtype]]):
    """The port's model for ``cfg`` holding ``weights`` (the tensors
    themselves, not copies).  Its parameters must be the leaves the
    reference names, shape and dtype alike."""
    from repro_torch.models import model as M

    model = M.model_class(cfg)(cfg)          # on the meta device
    have = {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}
    want = {k: (s, d) for k, s, d in leaves}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the program's parameters are not the "
                         f"reference's leaves: {diff}")
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def draw_tokens(seed: int, tag: str, i: int, shape: Tuple[int, ...],
                vocab: int, device) -> torch.Tensor:
    """Token ids uniform over ``vocab``, drawn on ``device`` from the
    seed, the stream's tag and the unit's index."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag, i))
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def mark(bench, name: str) -> None:
    """Note the seconds since the run's start at a step of set-up (printed
    on standard error, to see where set-up goes)."""
    if hasattr(bench, "marks"):
        bench.marks.append((name, time.time() - bench.t_start))
