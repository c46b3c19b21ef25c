"""PyTorch/CUDA port of the adaptive-checkpointing reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, keeps its own copies of the host-side modules it needs,
and runs on an NVIDIA GPU: the batched checkpoint-policy engine through a
hand-written CUDA sim-step kernel (:mod:`repro_torch.kernels.sim_step`),
mamba2-130m serving (:mod:`repro_torch.serve`) whose prefill runs the
SSD chunked scan as a hand-written CUDA kernel
(:mod:`repro_torch.kernels.ssd_scan`), and the dense family's serving
(olmo-1b to gemma2-27b) whose prefill attention runs a hand-written CUDA
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`).
A cell batch shards over a device mesh and the AdamW state over its data
axis (ZeRO-1) through :mod:`repro_torch.distributed`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
