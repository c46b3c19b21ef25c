"""P2P checkpoint-store laws (copies of ``repro.p2p``; numpy host code)."""
from repro_torch.p2p.store import R_MAX, StoreSpec
from repro_torch.p2p.transfer import TransferModel

__all__ = ["R_MAX", "StoreSpec", "TransferModel"]
