"""BAD: a torch generator drawn from in a scope and handed to a helper."""
import torch


def truncated_normal_init(gen, shape):
    return torch.randn(shape, generator=gen).clamp(-2.0, 2.0)


def init(seed: int):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(4, generator=g)
    w = truncated_normal_init(g, (4, 4))        # R002: shared stream
    return u, w


def init_kw(gen: torch.Generator):
    u = torch.rand(4, generator=gen)
    return u, truncated_normal_init(shape=(4,), gen=gen)   # R002
