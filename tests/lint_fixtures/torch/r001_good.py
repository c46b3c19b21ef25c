"""GOOD: every torch draw names a seeded generator."""
import torch

g = torch.Generator().manual_seed(0)            # construction, not a draw
noise = torch.randn(16, generator=g)
picks = torch.randint(0, 5, (3,), generator=g)
perm = torch.randperm(5, generator=g)


def init(w, gen: torch.Generator):
    w.uniform_(-0.1, 0.1, generator=gen)
    return torch.empty(3).normal_(0.0, 1.0, generator=gen)
