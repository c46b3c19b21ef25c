"""Model serving of the port (prefill + decode)."""
from repro_torch.serve.step import (greedy_generate, make_prefill_step,
                                    make_serve_step)

__all__ = ["greedy_generate", "make_prefill_step", "make_serve_step"]
