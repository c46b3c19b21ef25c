"""Serving on the port: model serving (prefill + decode) and the
checkpoint-interval policy service."""
from repro_torch.serve.policy_service import (
    CalibrationReport,
    DecisionBatch,
    PolicyService,
    synthetic_stream,
)
from repro_torch.serve.step import (greedy_generate, make_prefill_step,
                                    make_serve_step)

__all__ = [
    "CalibrationReport",
    "DecisionBatch",
    "PolicyService",
    "greedy_generate",
    "make_prefill_step",
    "make_serve_step",
    "synthetic_stream",
]
