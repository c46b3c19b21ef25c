"""The yardstick's counts against independent ones at SMOKE size: the
port's own cost counter (``launch.cost_analysis.CostCounter``, which
counts the products the program runs) and its kernels' work functions,
with the differences the definitions make stated term by term:

* attention: the yardstick counts the causal half, S (S + 1) / 2 pairs;
  the program's plain attention and ``flash_attention.work`` the full
  square;
* the SSD: the yardstick counts the causal pairs of each chunk and the
  state's pass from chunk to chunk; ``ssd_chunked`` and
  ``ssd_scan.chunked_work`` the full Q x Q products and no pass;
* the conv: a depthwise product the yardstick counts, which the program
  runs as elementwise multiplies (no product op for the counter).
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from harness import core, counts  # noqa: E402
from harness.program import load_model  # noqa: E402
from harness.weights import make_weights  # noqa: E402
from reference import mamba2, olmo  # noqa: E402


def _smoke(workload):
    """The program's model at the cell's SMOKE sizes, its kernels off."""
    cell = core.load_cell(workload)
    cfg = core.scaled(cell.config, "smoke")
    ref = {"mamba2": mamba2, "olmo": olmo}[cfg["reference"]]
    mcfg = dataclasses.replace(core.model_config(cfg),
                               use_flash_kernel=False)
    model = load_model(mcfg,
                       make_weights(ref.leaves(cfg["model"]), cfg["init"],
                                    3, "cpu"), ref.leaves(cfg["model"]))
    return cfg["model"], model


def _counted(model, m, tokens):
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.models.model import forward

    cfg = model.cfg
    with torch.no_grad(), CostCounter() as cc:
        forward(model, {"tokens": tokens}, cfg)
    return cc.report.dot_flops


def test_dense_forward_matches_cost_counter():
    m, model = _smoke("olmo-1b.train-2k")
    B, S = 2, 48
    got = _counted(model, m, torch.randint(0, m["vocab"], (B, S)))
    a = m["attention"]
    causal = counts.flash_call(B * a["n_kv_heads"],
                               a["n_heads"] // a["n_kv_heads"], S,
                               a["head_dim"])["flops"]
    square = counts.flash_call(B * a["n_kv_heads"],
                               a["n_heads"] // a["n_kv_heads"], S,
                               a["head_dim"], causal=False)["flops"]
    want = counts.forward_flops(m, B, S, B * S) \
        + m["n_layers"] * (square - causal)
    assert got == pytest.approx(want, rel=1e-12)


def test_ssm_forward_matches_cost_counter():
    from repro_torch.kernels.ssd_scan import chunked_work

    m, model = _smoke("mamba2-2.7b.prefill-2k")
    B, S = 2, 64
    got = _counted(model, m, torch.randint(0, m["vocab"], (B, S)))
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    h, p, n, q = di // s["head_dim"], s["head_dim"], s["d_state"], s["chunk"]
    ours_ssd = counts.ssd_call(B, S, h, p, n, q)["flops"]
    conv = 2.0 * B * S * s["conv_width"] * (di + 2 * n)
    want = counts.forward_flops(m, B, S, B * S) \
        - m["n_layers"] * (ours_ssd - chunked_work(B, S, h, p, n, q) + conv)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("b,s,h,p,n,q", [(2, 64, 4, 16, 16, 32),
                                         (8, 2048, 80, 64, 128, 256)])
def test_ssd_call_against_chunked_work(b, s, h, p, n, q):
    from repro_torch.kernels.ssd_scan import chunked_work

    nc = s // q
    pairs = q * (q + 1) // 2
    ours = counts.ssd_call(b, s, h, p, n, q)["flops"]
    diff = b * nc * (2 * (pairs - q * q) * n + h * 2 * (pairs - q * q) * p
                     + h * 2 * p * n)
    assert ours - diff == chunked_work(b, s, h, p, n, q)


@pytest.mark.parametrize("bg,r,s,d", [(4, 2, 48, 16), (256, 1, 2048, 128)])
def test_flash_call_against_work(bg, r, s, d):
    from repro_torch.kernels.flash_attention import work

    assert counts.flash_call(bg, r, s, d, causal=False)["flops"] == \
        work(bg, r, s, s, d)
    half = counts.flash_call(bg, r, s, d)["flops"]
    assert half == 4 * bg * r * d * s * (s + 1) // 2


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill-2k",
                                      "olmo-1b.train-2k"])
def test_n_params_and_file(workload):
    """The parameter count (from the sizes alone) equals the program's
    model's, at the full sizes (on the meta device) and at SMOKE; the
    configuration file states it."""
    from repro_torch.models import model as M

    cell = core.load_cell(workload)
    for scale in ("full", "smoke"):
        cfg = core.scaled(cell.config, scale)
        mod = M.model_class(core.model_config(cfg))(core.model_config(cfg))
        assert counts.n_params(cfg["model"]) == sum(
            p.numel() for p in mod.parameters())
    assert cell.config["params"] == counts.n_params(cell.config["model"])


def test_olmo_file_is_the_registry_config():
    """The olmo-1b file's model is the port's registry configuration."""
    from repro_torch.configs import get_config

    cell = core.load_cell("olmo-1b.train-2k")
    assert core.model_config(cell.config) == get_config("olmo-1b")


def test_ssd_bytes_each_input_once():
    b, s, h, p, n = 8, 2048, 80, 64, 128
    got = counts.ssd_call(b, s, h, p, n, 256)["bytes"]
    x = y = b * s * h * p * 2
    bc = 2 * b * s * n * 2
    dt, a = b * s * h * 4, h * 4
    states = 2 * b * h * p * n * 4
    assert got == x + y + bc + dt + a + states


@pytest.mark.parametrize("workload,kernel,per_call", [
    ("mamba2-2.7b.prefill-2k", "ssd_scan",
     lambda: counts.ssd_call(8, 2048, 80, 64, 128, 256)),
    ("olmo-1b.prefill-2k", "flash_attention",
     lambda: counts.flash_call(256, 1, 2048, 128))])
def test_kernel_work_is_a_call_a_layer(workload, kernel, per_call):
    """A request's work of a kernel is one call's at the cell's shape for
    each layer of the model that makes it, and none for a model with no
    such layer."""
    cell = core.load_cell(workload)
    m, t = cell.config["model"], cell.traffic
    got = counts.kernel_work(m, kernel, t["batch"], t["prompt_len"])
    want = per_call()
    assert got == {k: m["n_layers"] * v for k, v in want.items()}
    other = {"ssd_scan": "flash_attention",
             "flash_attention": "ssd_scan"}[kernel]
    assert counts.kernel_work(m, other, t["batch"], t["prompt_len"]) is None


def test_a_new_family_and_kernel_are_files(tmp_path, monkeypatch):
    """A family and a kernel the harness has never seen arrive as files
    of their own: the counts, the kernel's work and the trace's names
    find them by name, with no edit to the harness."""
    from harness import trace

    fam, ker = tmp_path / "families", tmp_path / "kernels"
    fam.mkdir()
    ker.mkdir()
    (fam / "stubfam.py").write_text(
        "def forward_flops(m, batch, seq, logits_rows):\n"
        "    return 7.0 * batch * seq\n"
        "def n_params(m):\n"
        "    return 11\n"
        "def layers(m):\n"
        "    return {'stublayer': 3}\n")
    (ker / "stub_kernel.py").write_text(
        "NAMES = ('stub_kernel_device_name',)\n"
        "LAYER = 'stublayer'\n"
        "def layer_work(m, batch, seq):\n"
        "    return {'flops': 2.0 * batch * seq, 'bytes': 5.0}\n")
    monkeypatch.setattr(counts, "FAMILIES", fam)
    monkeypatch.setattr(counts, "KERNELS", ker)
    m = {"family": "stubfam"}
    assert counts.forward_flops(m, 2, 4, 2) == 56.0
    assert counts.train_step_flops(m, 2, 4) == 168.0
    assert counts.n_params(m) == 11
    assert counts.kernel_names() == ["stub_kernel"]
    assert counts.kernel_work(m, "stub_kernel", 2, 4) == \
        {"flops": 48.0, "bytes": 15.0}
    with pytest.raises(ValueError, match="no count for family"):
        counts.family({"family": "absent"})

    class Prof:                    # a trace holding one stub launch
        def events(self):
            from torch.autograd import DeviceType

            class E:
                name = "stub_kernel_device_name<1>"
                device_type = DeviceType.CUDA
                kernels = []
                cpu_parent = None

                class time_range:
                    start, end = 10.0, 30.0
            return [E()]

    t = trace.TraceSummary(Prof(), host_window_s=4e-5)
    assert t.port_kernel_s("stub_kernel") == pytest.approx(2e-5)
    assert t.busy_s == pytest.approx(2e-5) and t.window_s == 4e-5
