"""The port's cost counter and dry run, on the CPU.

* ``launch.cost_analysis.CostCounter``'s dot FLOPs for a SMOKE olmo
  prefill and train step (remat none) against the reference's loop-aware
  ``repro.launch.hlo_analysis.analyze_hlo`` of the same jitted JAX steps,
  built as ``tests/test_e2e_integration.py`` builds them: within 5%;
* ``tests/test_hlo_analysis.py`` mirrored: one matmul; a loop of 10
  counts 10; nested loops 4 x 3 count 12; the collectives' bytes by kind;
* composite ops (``matmul``, ``einsum``) count the same inside
  ``torch.inference_mode`` as outside it, and the live-bytes high-water
  mark follows allocations and frees;
* the flash wrapper (on the meta device, where it stands in for the
  kernel) and its plain version report equal work, and the SSD wrapper
  reports what ``ssd_chunked`` counts;
* mesh position 0's numbers (the dry run runs that position alone)
  against running every position of a (2, 2) abstract mesh at SMOKE (the
  dense, moe, ssm and hybrid stacks; zamba2's decode with its K/V along
  the sequence over the data positions), and of a (2, 4) one (starcoder2
  by its kv_seq and head_dim rules, whisper by its heads): the whole
  mesh's FLOPs and bytes are the positions' count times position 0's,
  and the collective bytes (counted once, for the group of position 0)
  equal;
* records: one production cell on meta (``olmo-1b`` ``decode_32k``,
  single pod), a skipped cell and the unsupported layout (``kv_seq`` on
  the data axis of a dense and an encdec model), and the CLI.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as R_smoke
from repro.data import DataConfig, SyntheticLM
from repro.launch.hlo_analysis import analyze_hlo
from repro.serve import make_prefill_step as R_prefill_step
from repro.train import AdamWConfig as R_Adam
from repro.train import constant as R_constant
from repro.train import init_train_state as R_init_state
from repro.train import make_train_step as R_train_step
import repro_torch.configs as T_cfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import mesh as T_mesh
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as D
from repro_torch.models import model as T_model
from repro_torch.models import ssm as T_ssm
from repro_torch.serve import step as T_serve
from repro_torch.train import optimizer as T_opt
from repro_torch.train import schedule as T_sched
from repro_torch.train import step as T_step

HLO_REL = 0.05


def _count(fn, *args, **kw) -> CA.CostReport:
    with CA.CostCounter() as c:
        fn(*args, **kw)
    return c.report


# ------------------------------------------------- against analyze_hlo
def _smoke_batch(cfg):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4))
    return data.batch_at(0)


def test_counter_matches_hlo_on_the_smoke_prefill():
    rcfg, tcfg = R_smoke("olmo-1b"), T_cfg.get_smoke_config("olmo-1b")
    assert rcfg.remat == tcfg.remat == "none"
    tokens = jax.ShapeDtypeStruct((4, 16), jnp.int32)
    params = jax.eval_shape(
        lambda: __import__("repro.models", fromlist=["init_params"])
        .init_params(jax.random.key(0), rcfg))
    comp = jax.jit(R_prefill_step(rcfg, max_seq=24)).lower(
        params, {"tokens": tokens}).compile()
    want = analyze_hlo(comp.as_text()).dot_flops
    model = T_model.model_class(tcfg)(tcfg)
    got = _count(T_serve.make_prefill_step(tcfg, max_seq=24), model,
                 {"tokens": torch.empty(4, 16, dtype=torch.int32,
                                        device="meta")}).dot_flops
    assert got == pytest.approx(want, rel=HLO_REL)


def test_counter_matches_hlo_on_the_smoke_train_step():
    rcfg, tcfg = R_smoke("olmo-1b"), T_cfg.get_smoke_config("olmo-1b")
    batch = _smoke_batch(rcfg)
    state = jax.eval_shape(lambda: R_init_state(jax.random.key(0), rcfg))
    comp = jax.jit(R_train_step(rcfg, R_Adam(), R_constant(1.0))).lower(
        state, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in batch.items()}).compile()
    want = analyze_hlo(comp.as_text()).dot_flops
    params = T_model.model_class(tcfg)(tcfg).requires_grad_(True)
    t_state = T_step.TrainState(params, T_opt.init_adamw(dict(
        params.named_parameters())))
    t_batch = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
               for k, v in batch.items()}
    step = T_step.make_train_step(tcfg, T_opt.AdamWConfig(),
                                  T_sched.constant(1.0))
    got = _count(step, t_state, t_batch).dot_flops
    assert got == pytest.approx(want, rel=HLO_REL)


# ---------------------------------------- tests/test_hlo_analysis.py's
def test_single_matmul_flops():
    x, w = torch.empty(128, 256, device="meta"), torch.empty(
        256, 512, device="meta")
    assert _count(torch.matmul, x, w).dot_flops == 2 * 128 * 256 * 512


def test_loop_of_ten_counts_ten():
    x = torch.empty(128, 128, device="meta")
    ws = torch.empty(10, 128, 128, device="meta")

    def looped():
        c = x
        for w in ws:
            c = c @ w

    assert _count(looped).dot_flops == 10 * 2 * 128 ** 3


def test_nested_loops_multiply():
    x = torch.empty(64, 64, device="meta")
    ws = torch.empty(4, 64, 64, device="meta")

    def nested():
        c = x
        for w in ws:
            for _ in range(3):
                c = c @ w

    assert _count(nested).dot_flops == 12 * 2 * 64 ** 3


def test_collective_bytes_by_kind():
    g = torch.Generator().manual_seed(0)
    pieces = [torch.randn(128, 64, generator=g) for _ in range(4)]

    def run():
        C.all_reduce(pieces)
        C.all_gather(pieces, 0)
        C.reduce_scatter(pieces, 0)
        C.all_reduce(pieces, origin=False)    # another group: not counted

    rep = _count(run)
    one = 128 * 64 * 4
    assert rep.collective_bytes == {"all-reduce": one, "all-gather": one,
                                    "reduce-scatter": one}
    assert rep.total_collective_bytes == 3 * one
    assert rep.dot_flops == 0 and rep.bytes_accessed == 0   # paused


def test_inference_mode_counts_composite_ops_alike():
    a = torch.empty(2, 3, 4, device="meta")
    b = torch.empty(4, 5, device="meta")

    def run():
        a @ b
        torch.einsum("abc,cd->abd", a, b)

    reps = []
    for inference in (False, True):
        with torch.inference_mode(inference):
            reps.append(_count(run))
    assert reps[0].dot_flops == reps[1].dot_flops == 2 * 2 * (2 * 3 * 4 * 5)
    assert reps[0].bytes_accessed == reps[1].bytes_accessed > 0


def test_high_water_follows_frees():
    def run():
        x = torch.empty(1000, device="meta")    # 4,000 B
        y = x.view(10, 100)                     # a view: nothing new
        del x, y
        z = torch.empty(500, device="meta")     # 2,000 B, after the free
        return z

    rep = _count(run)
    assert rep.high_water_bytes == 4000


# ---------------------------------------------------- kernels' reports
def test_flash_wrapper_reports_its_plain_versions_work():
    shape = dict(bg=4, r=2, sq=16, skv=24, d=32)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g)
               for s in ((4, 2, 16, 32), (4, 24, 32), (4, 24, 32)))
    plain = _count(FA.flash_attention_plain, q, k, v, scale=0.1)
    meta = _count(FA.flash_attention, *(t.to("meta") for t in (q, k, v)),
                  scale=0.1)
    want = FA.work(shape["bg"], shape["r"], shape["sq"], shape["skv"],
                   shape["d"])
    assert plain.dot_flops == meta.dot_flops == meta.kernel_flops == want
    assert meta.kernel_bytes == sum(CA.nbytes(t) for t in (q, k, v, q))


@pytest.mark.parametrize("s,chunk", [(64, 32), (40, 32)])
def test_ssd_wrapper_reports_ssd_chunkeds_work(s, chunk):
    b, h, p, n = 2, 3, 8, 16
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, s, h, p, generator=g)
    dt, A = torch.rand(b, s, h, generator=g), -torch.rand(h, generator=g)
    B, Cc = (torch.randn(b, s, n, generator=g),
             torch.randn(b, s, n, generator=g))
    plain = _count(T_ssm.ssd_chunked, x, dt, A, B, Cc, chunk)
    assert plain.dot_flops == SSD.chunked_work(b, s, h, p, n, chunk)
    if s % chunk == 0:
        meta = _count(SSD.ssd_scan, *(t.to("meta") for t in
                                      (x, dt, A, B, Cc)), chunk=chunk)
        assert meta.dot_flops == meta.kernel_flops == plain.dot_flops


# ------------------------------------ position 0 against every position
POSITION_CASES = [
    ("olmo-1b", "prefill", 8, (2, 2)), ("olmo-1b", "decode", 8, (2, 2)),
    ("olmo-1b", "train", 8, (2, 2)), ("olmoe-1b-7b", "train", 8, (2, 2)),
    ("deepseek-moe-16b", "prefill", 8, (2, 2)),
    ("zamba2-7b", "train", 8, (2, 2)), ("zamba2-7b", "decode", 1, (2, 2)),
    ("mamba2-130m", "prefill", 8, (2, 2)),
    ("starcoder2-3b", "train", 8, (2, 4)),
    ("starcoder2-3b", "prefill", 8, (2, 4)),
    ("starcoder2-3b", "decode", 8, (2, 4)),
    ("whisper-large-v3", "prefill", 8, (2, 4)),
    ("whisper-large-v3", "decode", 8, (2, 4))]


@pytest.mark.parametrize("arch,kind,batch,mesh", POSITION_CASES, ids=[
    f"{a}-{k}-{b}" + ("" if m == (2, 2) else f"-{m[0]}x{m[1]}")
    for a, k, b, m in POSITION_CASES])
def test_position_zero_equals_every_position(arch, kind, batch, mesh):
    """zamba2's decode at batch 1: every data position runs the whole
    batch and holds half the K/V sequence (a masked write of the new
    token's K/V on each).  starcoder2 over (2, 4): its train and prefill
    cells resolve ``kv_seq`` on the model axis (every position its part
    of the keys), its decode cell ``head_dim``; whisper's 4 heads split
    over 4 (the encdec Megatron split)."""
    cfg = T_cfg.get_smoke_config(arch)
    mesh = T_mesh.Mesh(mesh, ("data", "model"))
    n = mesh.size
    shape = ShapeConfig("small", 16, batch, kind)
    kw = dict(cfg_override=cfg, mesh=mesh, shape=shape, n_microbatches=2)
    one = D.run_cell(arch, None, **kw)
    every = D.run_cell(arch, None, every_position=True, **kw)
    assert one["status"] == every["status"] == "ok"
    a, b = one["cost"], every["cost"]
    assert b["dot_flops"] == n * a["dot_flops"] > 0
    assert b["bytes_accessed"] == n * a["bytes_accessed"]
    assert b["collective_bytes"] == a["collective_bytes"]
    assert b["collective_counts"] == a["collective_counts"]
    assert a["total_collective_bytes"] > 0


# ------------------------------------------------------------ records
def test_production_cell_on_meta():
    rec = D.run_cell("olmo-1b", "decode_32k", False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["model_axes"] == ["heads", "kv_heads", "mlp", "vocab"]
    mem = rec["memory_per_device"]
    # the cache of 128 sequences of 32,768 tokens: 8 rows a device, the
    # 16 kv heads 1 a device, 16 layers, K and V, bf16
    assert mem["cache_bytes"] == 16 * 8 * 1 * 32768 * 128 * 2 * 2
    assert mem["parameter_bytes"] < 2 * 1.18e9 / 16 * 1.01
    assert mem["fits"] and mem["peak_estimate_bytes"] > mem["cache_bytes"]
    assert rec["cost"]["dot_flops"] > 0
    assert set(rec["cost"]["collective_bytes"]) == {"all-reduce",
                                                    "all-gather"}
    assert rec["roofline"]["dominant"] == "memory_seconds"
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert rec["hardware"] == D.HARDWARE


def test_skipped_and_unsupported_records():
    """The one layout still refused: ``kv_seq`` on the data axis of a
    dense (or encdec) model, a batch of 1 over (2, 2), on the model axis
    nothing the port does not split."""
    rec = D.run_cell("olmo-1b", "long_500k", True)
    assert rec["status"] == "skipped" and rec["reason"] == D.SKIP_REASON
    mesh = T_mesh.Mesh((2, 2), ("data", "model"))
    for arch, kind in (("olmo-1b", "decode"), ("whisper-large-v3",
                                               "prefill")):
        rec = D.run_cell(arch, None,
                         cfg_override=T_cfg.get_smoke_config(arch),
                         mesh=mesh, shape=ShapeConfig("small", 32, 1, kind))
        assert rec["status"] == "unsupported" and rec["axes"] == ["kv_seq"]


def test_cli_writes_one_record_a_cell(tmp_path):
    D.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["olmo-1b__decode_32k__multi.json",
                     "olmo-1b__decode_32k__single.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "multi"
    assert rec["chips"] == 512 and rec["rows"] == 4


def test_production_meshes():
    from repro_torch.launch.mesh import make_production_mesh

    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert single.devices is None and multi.size == 512
    real = make_production_mesh(devices=["cpu"] * 256)
    assert real.devices == (torch.device("cpu"),) * 256
    with pytest.raises(ValueError, match="256 devices"):
        make_production_mesh(devices=["cpu"] * 4)
