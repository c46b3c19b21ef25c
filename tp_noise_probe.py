"""Where a split mamba2-130m's bf16 logits part from the unsplit model's.

mamba2-130m drawn on the card as ``chip_smoke.py``'s TP6 draws it (batch
8, prompt 1024, one teacher-forced decode step), split over its SSM
heads at model extent 2 on one card:

* stage by stage at layers 0 and 12 of a prefill, on the unsplit
  model's own inputs: each shard's z, x, dt, B and C against the unsplit
  ``in_proj``'s columns, its SSD output and final state, one recurrent
  step from that state, the gated norm's statistic, the row-parallel
  ``out_proj`` summed over the shards (and both against float64), and
  the last position's logits columns;
* at a decode step's 8 rows: each shard's ``in_proj`` products as bf16
  products and as float32 sums rounded once, against the unsplit
  product's columns;
* TP6's reading (``chip_smoke._floor_rule``: the split's logits against
  the unsplit kernel path's, the floor the unsplit kernel path against
  the plain path), per logits row, with the shard's ``in_proj`` as the
  port computes it and as bf16 products.

Run on a card from the repo root: ``python3 tp_noise_probe.py`` (about
40 s, the SSD kernel's build included).  Prints one line a measurement
and writes them to ``chiprun_out/tp_noise_probe.json``.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def _diff(a, b) -> dict:
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return dict(n_diff=int((d > 0).sum()), n=a.numel(),
                max_abs=float(d.max()))


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("tp_noise_probe: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as CS

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import build
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM

    build.build(["ssd_scan"])
    build.load("ssd_scan")
    cfg, model, prompt = CS.dense_setup("probe", "mamba2-130m")
    g = torch.Generator().manual_seed(2)
    forced = torch.randint(0, cfg.vocab, (CS.OLMO_BATCH, CS.TP_SPLIT_FORCED),
                           generator=g).to(prompt.device)
    cdt = torch.bfloat16
    m = 2
    dis, hs = SSM.shard_dims(cfg, m)
    d_inner, nheads, _ = SSM.ssm_dims(cfg)
    out = {}

    def record(key, value):
        out[key] = value
        print(f"[probe] {key}: {value}", flush=True)

    split = TP.split_model(model, CS._model_mesh((1, m)))
    group = split.group(0)
    with torch.no_grad():
        x = L.scale_embedding(L.embed_rows(model.embed, prompt), cfg)
        for li in range(13):
            blk = model.blocks[li]
            h = L.apply_norm(blk.norm, x, cfg).to(cdt)
            P = blk.mixer.params()
            proj = torch.einsum("bsd,de->bse", h, P["in_proj"].to(cdt))
            z, xx, Bv, Cv, dt = SSM._split_proj(cfg, proj)
            if li in (0, 12):
                c0 = SSM.init_ssm_cache(cfg, h.shape[0], device=h.device)
                yf, cf = SSM._mixer_ssm(cfg, z, xx, Bv, Cv, dt, P, None,
                                        d_inner, nheads, c0, True)
                last = slice(-1, None)
                y1, _ = SSM._mixer_ssm(cfg, z[:, last], xx[:, last],
                                       Bv[:, last], Cv[:, last],
                                       dt[:, last], P, None, d_inner, nheads,
                                       {k: v.clone() for k, v in cf.items()},
                                       True)
                yg = yf.float() * F.silu(z.float())
                var = yg.square().mean(dim=-1, keepdim=True)
                yn = yg * torch.rsqrt(var + cfg.norm_eps) * \
                    P["norm_scale"].float()
                out_u = torch.einsum("bse,ed->bsd", yn.to(cdt),
                                     P["out_proj"].to(cdt))
                ref = yn.to(cdt).double() @ P["out_proj"].to(cdt).double()
                parts, sums = [], 0
                for j, p in group:
                    mp = p.blocks[li].mixer.params()
                    w = mp["in_proj"].to(cdt)
                    zxdt = SSM._product_f32(h, w[:, :2 * dis + hs]).to(cdt)
                    bc = SSM._product_f32(h, w[:, 2 * dis + hs:]).to(cdt)
                    c, hsl = slice(j * dis, (j + 1) * dis), \
                        slice(j * hs, (j + 1) * hs)
                    tag = f"L{li} shard {j}"
                    record(f"{tag} z", _diff(zxdt[..., :dis], z[..., c]))
                    record(f"{tag} x", _diff(zxdt[..., dis:2 * dis],
                                             xx[..., c]))
                    record(f"{tag} dt", _diff(zxdt[..., 2 * dis:],
                                              dt[..., hsl]))
                    record(f"{tag} B, C", _diff(bc, torch.cat([Bv, Cv], -1)))
                    cj0 = SSM.init_ssm_cache(cfg, h.shape[0], device=h.device,
                                             n_shards=m)
                    yj, cj = SSM._mixer_ssm(cfg, z[..., c], xx[..., c], Bv,
                                            Cv, dt[..., hsl], mp, hsl, dis,
                                            hs, cj0, True)
                    record(f"{tag} SSD y", _diff(yj, yf[..., c]))
                    record(f"{tag} SSD state", _diff(cj["state"],
                                                     cf["state"][:, hsl]))
                    y1j, _ = SSM._mixer_ssm(
                        cfg, z[:, last, c], xx[:, last, c], Bv[:, last],
                        Cv[:, last], dt[:, last, hsl], mp, hsl, dis, hs,
                        {k: v.clone() for k, v in cj.items()}, True)
                    record(f"{tag} recurrent step y", _diff(y1j, y1[..., c]))
                    ygj = yj.float() * F.silu(z[..., c].float())
                    sums = sums + ygj.square().sum(-1, keepdim=True)
                    parts.append((mp, ygj))
                record(f"L{li} norm statistic", _diff(sums / d_inner, var))
                out_s = sum(SSM.mamba2_shard_out(mp, ygj, sums, cfg)
                            for mp, ygj in parts).to(cdt)
                record(f"L{li} out_proj split vs unsplit",
                       _diff(out_s, out_u))
                record(f"L{li} out_proj unsplit vs float64",
                       _diff(out_u, ref))
                record(f"L{li} out_proj split vs float64", _diff(out_s, ref))
            x = x + blk.mixer(h, use_kernel=True)[0].to(x.dtype)
        hf = L.apply_norm(model.final_norm, x[:, -1:], cfg)
        lu = L.logits_from_hidden(model.embed, hf, cfg)
        v = lu.shape[-1] // m
        for j, p in group:
            record(f"logits columns shard {j}", _diff(
                L.logits_from_hidden(p.embed, hf, cfg),
                lu[..., j * v:(j + 1) * v]))

        # a decode step's 8 rows: bf16 products and float32 sums
        h = torch.randn(CS.OLMO_BATCH, 1, cfg.d_model,
                        generator=torch.Generator().manual_seed(5)).to(
            prompt.device, cdt)
        for li in (0, 12):
            proj = torch.einsum("bsd,de->bse", h,
                                model.blocks[li].mixer.params()["in_proj"]
                                .to(cdt))
            z, xx, Bv, Cv, dt = SSM._split_proj(cfg, proj)
            for j, p in group:
                w = p.blocks[li].mixer.params()["in_proj"].to(cdt)
                c = slice(j * dis, (j + 1) * dis)
                want = torch.cat([z[..., c], xx[..., c]], -1)
                zxdt = w[:, :2 * dis + hs]
                bf16 = torch.einsum("bsd,de->bse", h, zxdt)[..., :2 * dis]
                f32 = SSM._product_f32(h, zxdt).to(cdt)[..., :2 * dis]
                record(f"decode L{li} shard {j} z, x as bf16 products",
                       _diff(bf16, want))
                record(f"decode L{li} shard {j} z, x as float32 sums",
                       _diff(f32, want))

    def bf16_shard(p, xin, cfg_, m_, j, *, cache=None, use_kernel=False):
        d_, h_ = SSM.shard_dims(cfg_, m_)
        n = cfg_.ssm.d_state
        w = p["in_proj"].to(cdt)
        xc = xin.to(cdt)
        zxdt = torch.einsum("bsd,de->bse", xc, w[:, :2 * d_ + h_])
        bc = torch.einsum("bsd,de->bse", xc, w[:, 2 * d_ + h_:])
        y, new = SSM._mixer_ssm(cfg_, zxdt[..., :d_], zxdt[..., d_:2 * d_],
                                bc[..., :n], bc[..., n:], zxdt[..., 2 * d_:],
                                p, slice(j * h_, (j + 1) * h_), d_, h_,
                                cache, use_kernel)
        yg = y.float() * F.silu(zxdt[..., :d_].float()).reshape(y.shape)
        return yg, yg.square().sum(dim=-1, keepdim=True), new

    whole, _ = CS._tp_serve(model, cfg, prompt, forced)
    plain, _ = CS._tp_serve(model, cfg.replace(use_flash_kernel=False),
                            prompt, forced)
    floor = CS._gap(whole, plain, CS.LOGIT_TOL)
    rows = range(whole.shape[0])
    record("floor rows", [CS._gap(whole[i], plain[i], CS.LOGIT_TOL)
                          ["max_ratio"] for i in rows])
    from unittest import mock
    for name, patch in (("as the port computes it", None),
                        ("as bf16 products", bf16_shard)):
        with mock.patch.object(SSM, "apply_mamba2_shard",
                               patch or SSM.apply_mamba2_shard):
            logits, _ = CS._tp_serve(split, cfg, prompt, forced)
        r = CS._floor_rule(logits, whole, floor, moe=False)
        record(f"TP6 reading, in_proj {name}", dict(
            max_ratio=r["max_ratio"], limit_ratio=r["limit_ratio"],
            rel_rms=r["rel_rms"], floor=floor["max_ratio"],
            rows=[CS._gap(logits[i], whole[i], CS.LOGIT_TOL)["max_ratio"]
                  for i in rows]))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "tp_noise_probe.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
