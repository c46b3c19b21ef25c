"""BAD: draws from the global torch RNG."""
import torch

torch.manual_seed(0)                            # R001: global reseed
torch.cuda.manual_seed_all(0)                   # R001: global reseed
noise = torch.randn(16)                         # R001: global draw
picks = torch.randint(0, 5, (3,))               # R001: global draw
like = torch.rand_like(noise)                   # R001: global draw


def init(w):
    w.uniform_(-0.1, 0.1)                       # R001: in-place global draw
    torch.nn.init.normal_(w)                    # R001: in-place global draw
    return torch.empty(3).normal_(0.0, 1.0)     # R001: in-place global draw
