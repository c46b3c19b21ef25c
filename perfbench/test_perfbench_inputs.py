"""The inputs and weights are reproducible from ``--seed``: the same seed
gives the same tokens and weights, another seed other ones, and any
whole number is a seed."""
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from harness import core, program  # noqa: E402
from harness.weights import make_weights  # noqa: E402
from reference import mamba2, olmo  # noqa: E402

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, -3, 2 ** 70])
def test_sub_seed_is_a_64_bit_seed(seed):
    s = core.sub_seed(seed, "request", 5)
    assert 0 <= s < 2 ** 64
    assert s == core.sub_seed(seed, "request", 5)
    assert s != core.sub_seed(seed, "request", 6)
    torch.Generator().manual_seed(s)


def test_tokens_reproducible_and_fresh_per_unit():
    a = program.draw_tokens(BIG, "request", 3, (2, 16), 1000, "cpu")
    b = program.draw_tokens(BIG, "request", 3, (2, 16), 1000, "cpu")
    c = program.draw_tokens(BIG, "request", 4, (2, 16), 1000, "cpu")
    d = program.draw_tokens(BIG + 1, "request", 3, (2, 16), 1000, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert int(a.min()) >= 0 and int(a.max()) < 1000


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill-2k",
                                      "olmo-1b.train-2k"])
def test_weights_reproducible(workload):
    cell = core.load_cell(workload)
    cfg = core.scaled(cell.config, "smoke")
    ref = {"mamba2": mamba2, "olmo": olmo}[cfg["reference"]]
    leaves = ref.leaves(cfg["model"])
    w1 = make_weights(leaves, cfg["init"], 11, "cpu")
    w2 = make_weights(leaves, cfg["init"], 11, "cpu")
    w3 = make_weights(leaves, cfg["init"], 12, "cpu")
    assert list(w1) == [n for n, _, _ in leaves]
    for n, shape, dtype in leaves:
        assert w1[n].shape == shape and w1[n].dtype == dtype
        assert torch.equal(w1[n], w2[n])
        assert torch.isfinite(w1[n].float()).all()
    assert not torch.equal(w1["embed.tok"], w3["embed.tok"])


def test_mamba2_special_leaves_in_range():
    cell = core.load_cell("mamba2-2.7b.prefill-2k")
    cfg = core.scaled(cell.config, "smoke")
    w = make_weights(mamba2.leaves(cfg["model"]), cfg["init"], 5, "cpu")
    a = torch.exp(w["blocks.0.mixer.a_log"])
    dt = torch.nn.functional.softplus(w["blocks.0.mixer.dt_bias"])
    assert float(a.min()) >= 1.0 - 1e-5 and float(a.max()) <= 16.0 + 1e-4
    assert float(dt.min()) >= 0.001 * 0.999 and float(dt.max()) <= 0.1001


@pytest.mark.parametrize("workload", ["mamba2-2.7b.prefill-2k",
                                      "olmo-1b.train-2k",
                                      "olmo-1b.prefill-2k"])
def test_train_and_prefill_batches_reproducible(workload):
    cell = core.load_cell(workload)
    a = cell.kind.Bench(cell, BIG, "cpu", "smoke")
    b = cell.kind.Bench(cell, BIG, "cpu", "smoke")
    if hasattr(a, "batch"):
        (t1, l1), (t2, l2) = a.batch(2), b.batch(2)
        assert torch.equal(t1, t2) and torch.equal(l1, l2)
        assert torch.equal(t1[:, 1:], l1[:, :-1])
        assert not torch.equal(a.batch(3)[0], t1)
    else:
        assert torch.equal(a.tokens(2), b.tokens(2))
        assert not torch.equal(a.tokens(3), a.tokens(2))
        assert not torch.equal(a.tokens(0, "warmup"), a.tokens(0))
