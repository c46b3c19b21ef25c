"""PyTorch/CUDA port of the adaptive-checkpointing reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, keeps its own copies of the host-side modules it needs,
and runs the batched checkpoint-policy engine on an NVIDIA GPU through a
hand-written CUDA sim-step kernel (:mod:`repro_torch.kernels.sim_step`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
