"""The port's mamba2 serving slice against the JAX package, on the CPU.

The mamba2 SMOKE config (3 layers, d_model 64, chunk 16) with the JAX
package's ``init_params`` carried across by ``from_reference``: prefill
of a 32-token prompt (two chunks), its logits and SSM cache, then four
``decode_step``s teacher-forced on the same tokens, with
``use_flash_kernel`` on (JAX: the Pallas kernel in interpret mode; port:
the kernel's plain version, which the wrapper runs for CPU tensors) and
off (both: ``ssd_chunked``).

Tolerances: float32 parameters and compute at 1e-4; bfloat16 at 5e-2
(``tests/test_models_smoke.py``'s), because XLA and torch round bfloat16
intermediates at different places (XLA's CPU backend may keep a fused
elementwise chain in float32 where torch rounds after every op).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfg
import repro.models as R_models
from repro.serve import step as R_step
import repro_torch.configs as T_cfg
import repro_torch.models as T_models
from repro_torch.kernels import ssd_scan as TK
from repro_torch.launch import serve as T_launch
from repro_torch.models import model as T_model
from repro_torch.serve import step as T_step

ARCH = "mamba2-130m"
BATCH, PROMPT, N_DECODE = 2, 32, 4


def _cfgs(dtype: str, kernel: bool):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, use_flash_kernel=kernel)
    return (R_cfg.get_smoke_config(ARCH).replace(**kw),
            T_cfg.get_smoke_config(ARCH).replace(**kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_prefill_and_decode_match_reference(dtype, tol, kernel):
    rcfg, tcfg = _cfgs(dtype, kernel)
    params = R_models.init_params(jax.random.key(0), rcfg)
    model = T_models.from_reference(_np_tree(params), tcfg, device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, rcfg.vocab, (BATCH, PROMPT + N_DECODE),
                        dtype=np.int32)
    prompt = toks[:, :PROMPT]
    max_seq = PROMPT + N_DECODE

    before = TK.LAUNCHES
    lt, ct = T_models.prefill(model, torch.from_numpy(prompt).long(), tcfg,
                              max_seq)
    lr, cr = R_models.prefill(params, jnp.asarray(prompt), rcfg, max_seq)
    assert TK.LAUNCHES == before
    assert tuple(lt.shape) == (BATCH, 1, rcfg.vocab)
    assert lt.dtype == torch.float32
    _close(lt, lr, tol)
    assert ct["index"] == int(cr["index"]) == PROMPT
    for k in ("state", "conv"):
        assert ct["ssm"][k].dtype == torch.float32          # whatever dtype
        assert cr["ssm"][k].dtype == jnp.float32
        _close(ct["ssm"][k], cr["ssm"][k], tol)

    for i in range(N_DECODE):
        tok = toks[:, PROMPT + i: PROMPT + i + 1]
        lt, ct = T_models.decode_step(model, ct, torch.from_numpy(tok).long(),
                                      tcfg)
        lr, cr = R_models.decode_step(params, cr, jnp.asarray(tok), rcfg)
        _close(lt, lr, tol)
        for k in ("state", "conv"):
            _close(ct["ssm"][k], cr["ssm"][k], tol)
    assert ct["index"] == PROMPT + N_DECODE


def test_prefill_of_prompt_off_the_chunk_grid_pads_for_the_kernel():
    """A 40-token prompt with chunk 16: the kernel takes only chunk
    multiples, so apply_mamba2 zero-pads for it as ssd_chunked pads; the
    knob-on port matches the JAX package's ssd_chunked path (whose kernel
    would refuse this length) and the port's own knob-off path."""
    rcfg, _ = _cfgs("float32", False)
    _, tcfg = _cfgs("float32", True)
    plain = tcfg.replace(use_flash_kernel=False)
    params = R_models.init_params(jax.random.key(3), rcfg)
    model = T_models.from_reference(_np_tree(params), tcfg, device="cpu")
    toks = np.random.default_rng(14).integers(0, rcfg.vocab, (BATCH, 41),
                                              dtype=np.int32)
    prompt, nxt = toks[:, :40], toks[:, 40:]
    assert 40 % tcfg.ssm.chunk
    lt, ct = T_models.prefill(model, torch.from_numpy(prompt).long(), tcfg, 48)
    lr, cr = R_models.prefill(params, jnp.asarray(prompt), rcfg, 48)
    lp, cp = T_models.prefill(model, torch.from_numpy(prompt).long(), plain,
                              48)
    _close(lt, lr, 1e-4)
    torch.testing.assert_close(lt, lp, rtol=1e-4, atol=1e-4)
    for k in ("state", "conv"):
        _close(ct["ssm"][k], cr["ssm"][k], 1e-4)
        torch.testing.assert_close(ct["ssm"][k], cp["ssm"][k], rtol=1e-4,
                                   atol=1e-4)
    lt, _ = T_models.decode_step(model, ct, torch.from_numpy(nxt).long(), tcfg)
    lr, _ = R_models.decode_step(params, cr, jnp.asarray(nxt), rcfg)
    _close(lt, lr, 1e-4)


# The layer options once refused here are ported (the norms, an untied
# head and the logit softcap: tests/test_torch_variants.py; the moe
# family: tests/test_torch_moe.py; float16: below; the audio frontend and
# the encdec family: tests/test_torch_encdec.py): the same calls build.
@pytest.mark.parametrize("change", [dict(frontend="audio_frames"),
                                    dict(family="encdec", n_enc_layers=1,
                                         enc_seq=8, d_ff=128)])
def test_audio_frontend_and_encdec_family_build(change):
    cfg = T_cfg.get_smoke_config(ARCH).replace(**change)
    model = T_models.init_params(0, cfg, device="cpu")
    assert isinstance(model, T_models.EncDecLM if cfg.family == "encdec"
                      else T_models.Mamba2LM)
    with pytest.raises(ValueError, match="unknown frontend"):
        T_models.init_params(0, cfg.replace(frontend="video"), device="cpu")


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b"])
def test_float16_forward_matches_reference(arch, kernel):
    """float16 parameters and compute (ROADMAP Queue 1 item 9.8): the
    forward without a cache and a prefill's logits against the JAX
    package's within 5e-2 (float16 carries 3 more mantissa bits than
    bfloat16).  The flash kernels take bfloat16 and float32 only, so with
    the knob on float16 runs _attention_core by its dtype."""
    from repro_torch.models import layers as T_layers

    kw = dict(param_dtype="float16", compute_dtype="float16")
    rcfg = R_cfg.get_smoke_config(arch).replace(**kw)
    tcfg = T_cfg.get_smoke_config(arch).replace(use_flash_kernel=kernel,
                                                **kw)
    assert not T_layers.flash_route(tcfg, q_offset=0, seq=32,
                                    layer_is_local=False)
    params = _np_tree(R_models.init_params(jax.random.key(2), rcfg))
    model = T_models.from_reference(params, tcfg, device="cpu")
    assert next(model.parameters()).dtype == torch.float16
    toks = np.random.default_rng(15).integers(0, rcfg.vocab, (BATCH, 32),
                                              dtype=np.int32)
    lt, _, _ = T_models.forward(model, {"tokens": torch.from_numpy(toks)
                                        .long()}, tcfg)
    lr, _, _ = R_models.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    _close(lt, lr, 5e-2)
    lt, _ = T_models.prefill(model, torch.from_numpy(toks).long(), tcfg, 40,
                             cache_dtype=torch.float16)
    lr, _ = R_models.prefill(params, jnp.asarray(toks), rcfg, 40,
                             cache_dtype=jnp.float16)
    _close(lt, lr, 5e-2)


def test_serve_steps_and_greedy_match_model_calls():
    rcfg, tcfg = _cfgs("float32", True)
    params = R_models.init_params(jax.random.key(1), rcfg)
    model = T_models.from_reference(_np_tree(params), tcfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab, (BATCH, 16))).long()
    pre = T_step.make_prefill_step(tcfg, max_seq=24)
    srv = T_step.make_serve_step(tcfg)
    l1, c1 = pre(model, {"tokens": prompt})
    l2, c2 = T_models.prefill(model, prompt, tcfg, 24)
    assert torch.equal(l1, l2)
    tok = l1[:, -1].argmax(-1)[:, None]
    d1, _ = srv(model, c1, {"tokens": tok})
    d2, _ = T_models.decode_step(model, c2, tok, tcfg)
    assert torch.equal(d1, d2)
    out = T_step.greedy_generate(model, tcfg, prompt, 5)
    assert tuple(out.shape) == (BATCH, 5)
    assert torch.equal(out[:, :1], tok)
    assert torch.equal(out[:, 1], d1[:, -1].argmax(-1))
    # the JAX package's greedy loop gives the same first tokens
    ref = R_step.greedy_generate(params, rcfg, jnp.asarray(prompt.numpy()), 2)
    np.testing.assert_array_equal(out[:, :2].numpy(), np.asarray(ref))


def test_forward_without_cache_matches_reference():
    rcfg, tcfg = _cfgs("float32", True)
    params = R_models.init_params(jax.random.key(2), rcfg)
    model = T_models.from_reference(_np_tree(params), tcfg, device="cpu")
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (BATCH, 32))
    lt, cache, _ = T_models.forward(model, {"tokens": torch.from_numpy(toks)},
                                    tcfg)
    lr, _, _ = R_models.forward(params, {"tokens": jnp.asarray(toks)}, rcfg)
    assert cache is None
    _close(lt, lr, 1e-4)


def test_from_reference_full_config_shapes_and_dtypes():
    """The full mamba2-130m pytree, built abstractly (no weights
    allocated), lands on the port's parameters name for name, shape for
    shape and dtype for dtype."""
    rcfg = R_cfg.get_config(ARCH)
    tcfg = T_cfg.get_config(ARCH)
    abstract = jax.eval_shape(lambda k: R_models.init_params(k, rcfg),
                              jax.random.key(0))
    zeros = jax.tree.map(
        lambda a: np.broadcast_to(np.zeros((), a.dtype), a.shape), abstract)
    model = T_models.from_reference(zeros, tcfg, device="meta")
    got = dict(model.named_parameters())
    flat = T_model.reference_state(zeros, tcfg)
    assert set(got) == set(flat)
    assert len(got) == 2 + 9 * rcfg.n_layers
    for k, a in flat.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype).split(".")[-1] == a.dtype.name, k
        assert got[k].device.type == "meta"
    assert sum(p.numel() for p in got.values()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(abstract))
    # the port's own init builds the same layout (smoke size)
    own = T_models.init_params(0, T_cfg.get_smoke_config(ARCH), device="cpu")
    ref = T_model.reference_state(
        _np_tree(R_models.init_params(jax.random.key(0),
                                      R_cfg.get_smoke_config(ARCH))),
        T_cfg.get_smoke_config(ARCH))
    for k, p in own.named_parameters():
        assert tuple(p.shape) == ref[k].shape, k
        assert str(p.dtype).split(".")[-1] == ref[k].dtype.name, k


def test_configs_match_reference_but_for_the_kernel_knob():
    for get in ("get_config", "get_smoke_config"):
        r = dataclasses.asdict(getattr(R_cfg, get)(ARCH))
        t = dataclasses.asdict(getattr(T_cfg, get)(ARCH))
        kr, kt = r.pop("use_flash_kernel"), t.pop("use_flash_kernel")
        assert r == t
        assert (kr, kt) == ((False, True) if get == "get_config"
                            else (False, False))
    assert T_cfg.ARCH_IDS == R_cfg.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        T_cfg.get_config("mamba3-130m")
    assert isinstance(T_models.init_params(
        0, T_cfg.get_smoke_config("whisper-large-v3"), device="cpu"),
        T_models.EncDecLM)


def test_entry_points_default_to_cuda():
    cfg = T_cfg.get_smoke_config(ARCH)
    if torch.cuda.is_available():
        model = T_models.init_params(0, cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T_models.init_params(0, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T_launch.main(["--arch", ARCH, "--smoke"])
        from repro_torch.launch import serve_policy, workflow_dag
        with pytest.raises(RuntimeError, match="no CUDA device"):
            workflow_dag.main(["--seeds", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            workflow_dag.main(["--seeds", "2", "--execute", "--p2p"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_policy.main(["--smoke"])


def test_launch_serve_runs_on_cpu(capsys):
    T_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "16", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 3 steps" in out
