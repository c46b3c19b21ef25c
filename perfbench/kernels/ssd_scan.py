"""The port's SSD kernel (``kernels/csrc/ssd_scan.cu``): one call a
Mamba2 layer, over the layer's (batch, seq, heads, head_dim) x and its
(batch, seq, d_state) B and C, at the configuration's chunk."""
from harness.counts import ssd_call, ssm_dims

# its device kernels in a trace, both routes
NAMES = ("ssd_scan_kernel", "ssd_chunk_state_kernel",
         "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
LAYER = "ssm"


def layer_work(m, batch, seq):
    di, h, p, n, w, q = ssm_dims(m)
    return ssd_call(batch, seq, h, p, n, min(q, seq))
