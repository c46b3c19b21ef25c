"""Plain-torch oracles for the port's kernels (the port of
``repro/kernels/ref.py``; the entries of kernels not ported yet wait for
their slices)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence -- the exact oracle.

    x: (b, s, h, p), dt: (b, s, h), A: (h,), B/C: (b, s, n).
    Returns y (b, s, h, p), final_state (b, h, p, n).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * A)[..., None, None]          # (b,h,1,1)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        state = state * dA + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state
