"""The port's flash kernel (``kernels/csrc/flash_attention.cu``): one
causal call an attention layer, over its key groups and query heads at
the real head_dim."""
from harness.counts import flash_call

# its device kernels in a trace, both routes
NAMES = ("flash_attention_kernel", "flash_tc_kernel")
LAYER = "attention"


def layer_work(m, batch, seq):
    a = m["attention"]
    return flash_call(batch * a["n_kv_heads"], a["n_heads"] // a["n_kv_heads"],
                      seq, a["head_dim"])
