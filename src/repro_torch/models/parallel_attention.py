"""Attention split over a mesh axis where the rules split no heads: the
parts of a key sequence and their combine, context parallelism (``kv_seq``
on the model axis) and the ``head_dim`` split.

The reference's rules (``distributed.sharding.resolve_rules``) put a
model's heads on the model axis only where both its query and its KV
heads divide the axis.  Where they do not (starcoder2-3b's 2 KV heads,
qwen2-vl-7b's 4, whisper-large-v3's 20 heads at 16), a call with more
than one query and a key sequence that divides the axis gets ``kv_seq``
there (context parallelism: train, forward, prefill), and a decode step
gets ``head_dim`` (the contraction's channels).  GSPMD partitions those
programs; the port runs them from one controller, a list of tensors one a
position, as ``distributed/collectives.py`` describes:

* **Context parallelism** (:func:`context_parallel`).  Every position
  computes q for every query row (``wq`` is whole there) and k and v for
  its part of the keys: a forward without a cache cuts the call's keys
  into balanced parts (:func:`balanced_parts`: sizes differ by at most
  one); a serving cache lies along the sequence in parts of ``T = max_seq
  / m`` slots (:func:`seq_part_write`).  Each part gives its normalised
  output and its rows' softmax statistics: through the flash kernel with
  the part's diagonal offset and ``stats=True`` where
  ``layers.flash_route`` takes the call (a part holding none of the call's
  keys launches nothing and gives the empty row's statistics), else
  through :func:`part_attention`, the plain form with statistics (which
  also applies a sliding window at the part's offset, and runs under
  autograd: the kernel has no backward).  :func:`combine` joins the parts.
  ``wo`` is whole on every position, so each computes the whole output
  and no collective follows it.
* **The combine** (:func:`combine`), one for every axis: the parts'
  maxima all-gathered, each part's output and sum rescaled to the
  greatest and all-reduced.  The hybrid family's K/V sequence over the
  data axis (``models.model._seq_split_attention``) combines by it too.
  The maxima are detached: the result does not depend on the stabiliser.
* **The head_dim split** (:func:`head_dim_core`).  ``wq``, ``wk`` and
  ``wv`` are cut into columns along ``head_dim``, ``wo`` into rows, the
  K/V caches along ``head_dim``; each shard rotates its channels with the
  whole head's frequency slots (``layers.apply_rope``'s ``channels``).
  The shards' partial q.k sums (float32) are all-reduced; the scale, the
  softcap, the mask and the softmax then run whole on every position,
  p.v over each shard's channels of v, and ``wo``'s partial outputs are
  all-reduced by the caller.  The flash kernel cannot take a partial
  score, so this layout always runs the plain attention.

Neither layout takes an int8 KV cache (``kv_cache_quant``): both raise
ValueError (ROADMAP: left).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

Part = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # o, m, l


def refuse_int8(cfg: ModelConfig, layout: str) -> None:
    if cfg.kv_cache_quant:
        raise ValueError(f"the {layout} layout takes a plain KV cache, not "
                         f"int8 codes (kv_cache_quant)")


def balanced_parts(n: int, m: int) -> List[Tuple[int, int]]:
    """``n`` keys over ``m`` positions: (start, length) of each part, the
    lengths differing by at most one, the longer parts first (1,500 frames
    over 16: twelve parts of 94, four of 93)."""
    q, r = divmod(n, m)
    out, start = [], 0
    for j in range(m):
        size = q + (j < r)
        out.append((start, size))
        start += size
    return out


def seq_part_write(buf: torch.Tensor, new: torch.Tensor, e: int,
                   index: int) -> None:
    """Write ``new`` (B, G, S, hd), the K or V of positions ``index`` ...
    ``index + S``, into ``buf`` (B, G, T, hd), sequence part ``e`` (its
    positions ``e·T`` ... ``(e + 1)·T``), in place: the slots of those
    positions the part holds.  A step of one token writes one slot,
    masked, on every part (the part that holds the position takes the
    token, the others rewrite their own value), so every part runs the
    same operations; a longer step rewrites the part's every slot, each
    from the prompt or from itself."""
    T, S = buf.shape[2], new.shape[2]
    new = new.to(buf.dtype)
    if S == 1:
        at = index - e * T
        li = min(max(at, 0), T - 1)
        mine = torch.tensor(0 <= at < T, device=buf.device)
        buf[:, :, li:li + 1] = torch.where(mine, new, buf[:, :, li:li + 1])
        return
    slot = torch.arange(T, device=buf.device) + (e * T - index)
    valid = (slot >= 0) & (slot < S)
    src = new.index_select(2, slot.clamp(0, S - 1))
    buf.copy_(torch.where(valid[None, None, :, None], src, buf))


def part_attention(qg, k, v, *, scale, softcap, causal, window, q_pos,
                   k_pos, kv_valid, cdt, q_chunk: int = 512) -> Part:
    """One part of a key sequence, in the plain form with statistics:
    queries ``qg`` (B, G, R, S, hd) at positions ``q_pos`` (S,) over keys
    ``k``, ``v`` (B, G, T, hd) at positions ``k_pos`` (T,); key t is
    visible to row i iff ``k_pos[t] <= q_pos[i]`` (causal), ``k_pos[t] >
    q_pos[i] - window`` (a window) and ``k_pos[t] < kv_valid``.  Scores
    multiplied in the compute dtype and scaled, softcapped and
    exponentiated in float32, as ``layers._attention_core``; p cast to the
    compute dtype before the product with v.  Returns the float32 output
    normalised by the part's own sum, and the rows' ``m`` and ``l`` (B, G,
    R, S), as the flash kernel's ``stats`` gives them (a row that sees no
    key: 0, ``NEG_INF``, 0).  Chunked over the queries as the plain path
    is."""
    outs = []
    for c0, c1 in L.query_chunks(qg.shape[3], q_chunk):
        s = torch.einsum("bgrsk,bgtk->bgrst", qg[..., c0:c1, :],
                         k).float() * scale
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        qp = q_pos[c0:c1, None]
        vis = (k_pos[None, :] <= qp) if causal else \
            torch.ones(c1 - c0, k_pos.shape[0], dtype=torch.bool,
                       device=qg.device)
        if window is not None:
            vis = vis & (k_pos[None, :] > qp - window)
        if kv_valid is not None:
            vis = vis & (k_pos[None, :] < kv_valid)
        s = torch.where(vis, s, L.NEG_INF)
        mx = s.detach().amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(s - mx), 0.0)
        den = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bgrst,bgtk->bgrsk", p.to(cdt), v).float()
        o = o / torch.where(den == 0, 1.0, den)
        outs.append((o, torch.where(den == 0, L.NEG_INF, mx)[..., 0],
                     den[..., 0]))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(t, dim=3) for t in zip(*outs))


def combine(parts: Sequence[Part], *, extent: int, origin: bool
            ) -> List[torch.Tensor]:
    """The whole attention from one part of the key sequence a position of
    an axis of ``extent`` (``parts[j]``: o (..., S, hd), each part's
    output normalised by its own sum, and its rows' m and l (..., S)):
    ``sum_j l_j exp(m_j - M) o_j / sum_j l_j exp(m_j - M)``, M the rows'
    greatest m, on every position, float32; 0 for a row no part sees.
    The maxima are all-gathered (detached: the result does not depend on
    them) and the rescaled outputs and sums all-reduced, as one tensor."""
    mxs = C.all_gather([m.detach()[..., None] for _, m, _ in parts], -1,
                       extent=extent, origin=origin)
    scaled = []
    for (o, m, l), every in zip(parts, mxs):
        w = (l * torch.exp(m.detach() - every.amax(dim=-1)))[..., None]
        scaled.append(torch.cat([o.float() * w, w], dim=-1))
    tot = C.all_reduce(scaled, extent=extent, origin=origin)
    return [t[..., :-1] / torch.where(t[..., -1:] == 0, 1.0, t[..., -1:])
            for t in tot]


def kernel_part(qg, k, v, *, scale, softcap, causal, off) -> Part:
    """One part through the flash kernel (``stats=True``; the diagonal
    offset ``off``), in :func:`part_attention`'s shapes: qg (B, G, R, S,
    hd), k and v (B, G, T, hd).  A part of no key launches nothing."""
    B, G, R, S, hd = qg.shape
    if k.shape[2] == 0:
        o, m, l = FA.empty_stats(qg)
        return o, m, l
    o, m, l = FA.flash_attention(
        qg.reshape(B * G, R, S, hd), k.reshape(B * G, -1, hd),
        v.reshape(B * G, -1, hd), scale=scale, causal=causal,
        softcap=softcap, off=off if causal else None, stats=True)
    return (o.reshape(B, G, R, S, hd), m.reshape(B, G, R, S),
            l.reshape(B, G, R, S))


def context_parallel(js: Sequence[int], m: int, ps, hs, cfg: ModelConfig,
                     positions, caches, *, cache_index: int,
                     layer_index: Optional[int], local_flag: bool,
                     causal: bool, origin: bool) -> List[torch.Tensor]:
    """One attention layer with ``kv_seq`` on the model axis: position
    ``js[i]`` of ``m`` holds the attention parameters ``ps[i]`` (whole),
    the normed input ``hs[i]`` (B, S, D), ``positions[i]`` and its cache
    ``caches[i]`` (a ``{"k", "v"}`` of (L, B, G, T, hd), its sequence part,
    or None).  Returns each position's whole attention output (B, S, D)
    (see the module docstring)."""
    a = cfg.attention
    refuse_int8(cfg, "kv_seq")
    cdt = L._dtype(cfg.compute_dtype)
    scale = L.query_scale(cfg)
    G, hd = a.n_kv_heads, a.head_dim
    window = a.sliding_window if local_flag else None
    flash = L.flash_route(cfg, q_offset=cache_index, seq=hs[0].shape[1],
                          layer_is_local=local_flag)
    parts = []
    for j, p, h, pos, c in zip(js, ps, hs, positions, caches):
        B, S, _ = h.shape
        dev = h.device
        qg = L.attention_q(p, h, cfg, pos).reshape(B, G, a.n_heads // G, S,
                                                   hd)
        if c is None:                     # a balanced part of own keys
            start, n = balanced_parts(S, m)[j]
            k, v = L.attention_kv(p, h[:, start:start + n], cfg,
                                  pos[..., start:start + n], seq=None)
            k_pos = torch.arange(n, device=dev) + start
            kv_valid = None
        else:                             # the cache's sequence part j
            ck, cv = c["k"][layer_index], c["v"][layer_index]
            T, idx = ck.shape[2], cache_index
            # the call's rows whose positions the part holds
            lo, hi = max(0, j * T - idx), min(S, (j + 1) * T - idx)
            k = v = None
            if S == 1:                    # every part writes, masked
                k1, v1 = L.attention_kv(p, h, cfg, pos, seq=None)
                seq_part_write(ck, k1, j, idx)
                seq_part_write(cv, v1, j, idx)
                if hi > lo:
                    k, v = k1, v1
            elif hi > lo:
                k, v = L.attention_kv(p, h[:, lo:hi], cfg, pos[..., lo:hi],
                                      seq=None)
                ck[:, :, idx + lo - j * T:idx + hi - j * T] = k.to(ck.dtype)
                cv[:, :, idx + lo - j * T:idx + hi - j * T] = v.to(cv.dtype)
            start = idx + lo
            if flash:
                # the call's own keys in the part, read back through the
                # cache's dtype as the unsplit prefill reads them
                k, v = ((ck[:, :, :0], cv[:, :, :0]) if k is None else
                        (k.to(ck.dtype).to(cdt), v.to(cv.dtype).to(cdt)))
                kv_valid = None
            else:
                k, v = ck.to(cdt), cv.to(cdt)
                start = j * T
                kv_valid = idx + S
            k_pos = torch.arange(k.shape[2], device=dev) + start
        if flash:
            parts.append(kernel_part(qg, k, v, scale=scale,
                                     softcap=a.softcap, causal=causal,
                                     off=cache_index - start))
        else:
            q_pos = torch.arange(S, device=dev) + cache_index
            parts.append(part_attention(
                qg, k.to(cdt), v.to(cdt), scale=scale, softcap=a.softcap,
                causal=causal, window=window, q_pos=q_pos, k_pos=k_pos,
                kv_valid=kv_valid, cdt=cdt))
    ctx = combine(parts, extent=m, origin=origin)
    return [L.attention_out(p, c.to(cdt), cfg, h.shape[0], h.shape[1],
                            h.dtype) for p, c, h in zip(ps, ctx, hs)]


def head_dim_core(qs, ks, vs, *, extent: int, origin: bool, scale, softcap,
                  causal, window, q_offset, kv_valid, cdt,
                  q_chunk: int = 512) -> List[torch.Tensor]:
    """The attention of ``head_dim`` shards: ``qs[j]`` (B, G, R, S, hd_j),
    ``ks[j]``, ``vs[j]`` (B, G, Sk, hd_j), a position each.  The partial
    scores (float32 products of the shard's channels) all-reduced, then
    scaled, softcapped, masked (queries at ``q_offset``, keys 0 ... Sk,
    ``window``, ``kv_valid``) and soft-maxed whole on every position, and
    p (in the compute dtype) times each shard's v.  Returns each shard's
    context (B, G, R, S, hd_j) in the compute dtype; chunked over the
    queries as the plain path is."""
    S = qs[0].shape[3]
    out = [[] for _ in qs]
    for c0, c1 in L.query_chunks(S, q_chunk):
        part = [torch.einsum("bgrsk,bgtk->bgrst", q[..., c0:c1, :].float(),
                             k.float()) for q, k in zip(qs, ks)]
        whole = C.all_reduce(part, extent=extent, origin=origin)
        for j, (s, v) in enumerate(zip(whole, vs)):
            q_pos = torch.arange(c0, c1, device=s.device) + q_offset
            probs = L.attention_probs(
                s, q_pos, scale=scale, softcap=softcap,
                causal=causal, sliding_window=window,
                local_flag=window is not None, kv_valid=kv_valid, cdt=cdt)
            out[j].append(torch.einsum("bgrst,bgtk->bgrsk", probs,
                                       v.to(cdt)))
    return [o[0] if len(o) == 1 else torch.cat(o, dim=3) for o in out]


def head_dim_split(js: Sequence[int], m: int, ps, hs, cfg: ModelConfig,
                   lcfg: ModelConfig, positions, caches, *,
                   cache_index: int, layer_index: Optional[int],
                   local_flag: bool, causal: bool, origin: bool
                   ) -> List[torch.Tensor]:
    """One attention layer with ``head_dim`` on the model axis: shard
    ``js[i]`` holds its channels of ``wq``/``wk``/``wv`` and its rows of
    ``wo`` (``ps[i]``), ``lcfg`` the shard's config (``head_dim / m`` and
    the whole head's softmax scale); its cache (``caches[i]``, or None)
    the shard's channels of every key.  Returns each shard's partial
    output (B, S, D) through its rows of ``wo``, for the caller's
    all-reduce."""
    refuse_int8(cfg, "head_dim")
    a = lcfg.attention
    cdt = L._dtype(cfg.compute_dtype)
    G, hd = a.n_kv_heads, a.head_dim
    qs, ks, vs = [], [], []
    for j, p, h, pos, c in zip(js, ps, hs, positions, caches):
        B, S, _ = h.shape
        q, k, v = L.attention_qkv(p, h, lcfg, pos,
                                  channels=(j * hd, cfg.attention.head_dim))
        if c is not None:
            ck, cv = c["k"][layer_index], c["v"][layer_index]
            ck[:, :, cache_index:cache_index + S] = k.to(ck.dtype)
            cv[:, :, cache_index:cache_index + S] = v.to(cv.dtype)
            k, v = ck.to(cdt), cv.to(cdt)
        qs.append(q.reshape(B, G, a.n_heads // G, S, hd))
        ks.append(k)
        vs.append(v)
    kv_valid = None if caches[0] is None else cache_index + hs[0].shape[1]
    ctx = head_dim_core(
        qs, ks, vs, extent=m, origin=origin, scale=L.query_scale(lcfg),
        softcap=a.softcap, causal=causal,
        window=a.sliding_window if local_flag else None,
        q_offset=cache_index if caches[0] is not None else 0,
        kv_valid=kv_valid, cdt=cdt)
    return [L.attention_out(p, c, lcfg, h.shape[0], h.shape[1], h.dtype)
            for p, c, h in zip(ps, ctx, hs)]
