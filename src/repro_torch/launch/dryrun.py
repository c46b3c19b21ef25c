"""Multi-pod dry run: one device's program for every (architecture x shape x
mesh) (the port of ``repro/launch/dryrun.py``).

For each cell this builds the port's real step -- the train step with
microbatched accumulation, AdamW and ZeRO-1, the prefill step or the
decode step over the cache -- split over the production mesh (16 x 16
single-pod, 2 x 16 x 16 multi-pod, ``launch/mesh.py``) by the rules
resolved for the cell, on the meta device, runs it under
``launch.cost_analysis.CostCounter`` and records:

* memory a device: the parameter, optimizer, gradient-accumulator and
  cache bytes of mesh position 0's pieces (from the specs), the high-water
  mark of every byte the step makes (activations, gradients, the
  optimizer's new state), and ``peak_estimate_bytes`` = the held state +
  that high-water mark, beside the card's 80 GB;
* the counter's dot FLOPs, bytes and collective bytes by kind;
* the roofline terms on an NVIDIA H100 80GB HBM3 at 700 W, and the
  dominant one;
* the analytic MODEL_FLOPS (6·N·D train / 2·N·D serve, active parameters
  for moe) and the share of the counted FLOPs they make.

**Position 0's program.**  The numbers are mesh position 0's.  The cell
runs that position alone: the split model holds its pieces only
(``tensor_parallel.split_model(..., positions=[(0, 0)])``), and the
collectives stand in for the other positions (``distributed/
collectives.py``), returning results of the right shapes and counting
what position 0 puts in.  Every position runs the same program (the
split stack is symmetric: each position computes its replicated parts and
its own copy of the loss), so position 0's numbers are any device's; the
tests hold that against running every position of a small mesh.

**Microbatches.**  As the reference: ``DEFAULT_MICROBATCHES = 16`` of the
global batch, and the ZeRO-1 accumulator inside the loop above 10e9
parameters.  Eager PyTorch splits a device's own rows, so a device runs
``min(16, its rows)`` microbatches (train_4k: 16 of one sequence on the
single pod, 8 of one on the multi-pod mesh, where the reference's 16
microbatches of 16 sequences do not divide over 32 data positions).

**What is not run.**  A cell the reference skips (``shape_applicable``)
is ``"skipped"`` with its reason; a cell whose rules put an axis a tensor
of the cell carries where the port does not split it
(``tensor_parallel.unsupported_axes``: ``kv_seq`` on the data axis
outside the hybrid family, which no production cell resolves: long_500k
is skipped for the dense and encdec archs) is ``"unsupported"`` and
names those axes.  Neither runs, and neither is run unsplit.  Of the 80
cells (10 archs x 4 shapes x 2 meshes) 64 are "ok" and 16 "skipped".
Where the heads do not divide the model axis (starcoder2-3b, qwen2-vl-7b
and whisper-large-v3) the train and prefill cells resolve ``kv_seq``
there (context parallelism) and the decode cells ``head_dim``
(``models/parallel_attention.py``); the cell's program is laid out by
its own rules (``split_model(..., rules)``, ``shard_train_state(...,
rules=)``).  Where the rules put nothing of the model on the model axis
(mamba2-130m) the model positions are replicas: the record is that of
the same cell on a mesh without a model axis.  Where the batch is off
the data axes (long_500k, batch 1) every data position runs the whole
batch, and zamba2-7b's KV cache lies along the sequence over the data
axis.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_out

It runs on a host without a GPU (the meta device allocates nothing).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, SHAPES_BY_NAME,
                                 get_config, input_specs, shape_applicable)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.mesh import MODEL_AXIS, Mesh, axis_size
from repro_torch.distributed.sharding import ShardingRules, resolve_rules
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit: the data sheet's dense
# bf16 tensor-core rate, the HBM3 rate, NVLink's rate a direction, and the
# memory the cells are judged against.
HARDWARE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
NVLINK_BW = 450e9            # bytes/s a direction
DEVICE_MEMORY = 80e9         # bytes a card

DEFAULT_MICROBATCHES = 16    # train_4k: 256-seq batch -> 16 microbatches
OUT_DIR = "dryrun_out"       # the default --out (listed in .gitignore)
SKIP_REASON = "full-attention arch at 500k context (DESIGN.md Sec 4)"


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rows(global_batch: int, rules: ShardingRules, mesh: Mesh) -> int:
    """A device's rows of the global batch (the batch's data axes)."""
    n = math.prod(mesh.shape[a] for a in rules.table.get("batch", ()))
    return global_batch // n


def local_microbatches(rows: int, requested: Optional[int]) -> int:
    """The microbatches a device runs: the largest count up to the
    requested (default 16) that divides its rows."""
    want = min(requested or DEFAULT_MICROBATCHES, rows)
    return max(k for k in range(1, want + 1) if rows % k == 0)


def _inputs(cfg: ModelConfig, shape: ShapeConfig, device,
            gen: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """The cell's global batch (``configs.specs.input_specs``): random
    tokens from ``gen`` on a real device, uninitialised on meta."""
    out = {}
    for k, (shp, dt) in input_specs(cfg, shape).items():
        if str(device) == "meta":
            out[k] = torch.empty(shp, dtype=dt, device="meta")
        elif dt.is_floating_point:
            out[k] = torch.randn(shp, generator=gen, device=device).to(dt)
        elif k == "positions":
            s = shp[-1]
            out[k] = torch.arange(s, device=device).expand(*shp).to(dt)
        else:
            out[k] = torch.randint(0, cfg.vocab, shp, generator=gen,
                                   device=device, dtype=dt)
    return out


def _model(cfg: ModelConfig, device, gen) -> torch.nn.Module:
    if str(device) == "meta":
        return M.model_class(cfg)(cfg)
    return M.init_params(gen, cfg, device=device)


def build_program(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                  rules: ShardingRules, *, n_microbatches: Optional[int]
                  = None, device="meta", seed: int = 0,
                  positions=((0, 0),)) -> Dict[str, Any]:
    """The cell's step, its arguments, and the bytes it holds before it
    runs, for mesh position 0 (or ``positions``; ``None``: every
    position).  On a real device the weights and tokens are drawn from a
    generator of ``seed`` there."""
    from repro_torch.serve.step import make_prefill_step, make_serve_step
    from repro_torch.train import optimizer as O
    from repro_torch.train import schedule as SC
    from repro_torch.train import step as T

    gen = None if str(device) == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    whole = mesh.size == 1
    pos = None if positions is None else list(positions)
    info: Dict[str, Any] = {"rows": _rows(shape.global_batch, rules, mesh)}
    batch = _inputs(cfg, shape, device, gen)
    if shape.kind == "train":
        tcfg = cfg.replace(use_flash_kernel=False)
        params = _model(tcfg, device, gen).requires_grad_(True)
        state = T.TrainState(params, O.init_adamw(dict(
            params.named_parameters())))
        if not whole:
            state = T.shard_train_state(state, mesh, positions=pos,
                                        rules=rules)
        n_micro = local_microbatches(info["rows"], n_microbatches)
        in_scan = cfg.n_params_estimate > 10e9
        info.update(n_microbatches=n_micro, zero1_grads_in_scan=in_scan)
        step = T.make_train_step(tcfg, O.AdamWConfig(), SC.constant(1.0),
                                 n_microbatches=n_micro,
                                 zero1_grads_in_scan=in_scan)
        if whole:
            opt = [state.opt]
            pieces = [state.params]
        else:
            opt, pieces = list(state.opts), state.params.modules()
        held_params = _nbytes(p for m in pieces[:1] for p in m.parameters())
        held_opt = _nbytes(t for o in opt[:1] for part in ("master", "m", "v")
                           for leaf in getattr(o, part).values()
                           for t in (leaf.shards if hasattr(leaf, "shards")
                                     else (leaf,)))
        # the float32 accumulator: the piece's leaves, or (in the loop)
        # their ZeRO-1 parts
        grad = held_opt // 3 if in_scan and not whole else 4 * sum(
            p.numel() for p in pieces[0].parameters())
        info["memory"] = dict(parameter_bytes=held_params,
                              optimizer_bytes=held_opt,
                              gradient_bytes=grad, cache_bytes=0)
        info["held"] = held_params + held_opt
        info["run"] = lambda: step(state, batch)
        return info
    params = _model(cfg, device, gen)
    if not whole:
        params = TP.split_model(params, mesh, rules, positions=pos)
    pieces = [params] if whole else params.modules()
    held_params = _nbytes(pieces[0].parameters())
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_seq=shape.seq_len)
        cache_bytes = _nbytes(_leaves(M.serving_cache(
            params, cfg, shape.global_batch, shape.seq_len,
            device="meta") if whole else params.init_cache(
            shape.global_batch, shape.seq_len)))
        held = held_params
        info["run"] = lambda: step(params, batch)
    else:
        cache = M.serving_cache(params, cfg, shape.global_batch,
                                shape.seq_len, device=device)
        cache["index"] = shape.seq_len - 1
        cache_bytes = _nbytes(_leaves(cache))
        held = held_params + cache_bytes
        step = make_serve_step(cfg)
        info["run"] = lambda: step(params, cache, batch)
    if not whole:
        cache_bytes //= len(pieces)
        held = held_params + (0 if shape.kind == "prefill" else cache_bytes)
    info["memory"] = dict(parameter_bytes=held_params, optimizer_bytes=0,
                          gradient_bytes=0, cache_bytes=cache_bytes)
    info["held"] = held
    return info


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def _record_cost(record: Dict[str, Any], cfg: ModelConfig,
                 shape: ShapeConfig, cost, info: Dict[str, Any]) -> None:
    mem = dict(info["memory"])
    mem["activation_high_water_bytes"] = cost.high_water_bytes
    mem["peak_estimate_bytes"] = info["held"] + cost.high_water_bytes
    mem["device_memory_bytes"] = DEVICE_MEMORY
    mem["fits"] = mem["peak_estimate_bytes"] <= DEVICE_MEMORY
    record["memory_per_device"] = mem
    record["cost"] = cost.to_dict()
    flops, byts = cost.dot_flops, cost.bytes_accessed
    record["roofline"] = {
        "compute_seconds": flops / PEAK_FLOPS,
        "memory_seconds": byts / HBM_BW,
        "collective_seconds": cost.total_collective_bytes / NVLINK_BW,
    }
    record["roofline"]["dominant"] = max(record["roofline"],
                                         key=record["roofline"].get)
    n_active = (cfg.decode_active_params_estimate if shape.kind == "decode"
                else cfg.n_active_params_estimate)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    record["model_flops_global"] = model_flops
    record["model_flops_per_chip"] = model_flops / record["chips"]
    record["useful_flops_ratio"] = record["model_flops_per_chip"] / max(
        flops, 1.0)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             n_microbatches: Optional[int] = None,
             cfg_override: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh: Optional[Mesh] = None, device="meta", seed: int = 0,
             every_position: bool = False) -> Dict[str, Any]:
    """One cell's record (see the module docstring).  ``shape`` and
    ``mesh`` replace the named shape and the production mesh (a (1, 1)
    mesh runs the unsplit program); ``device`` other than meta runs the
    same program there, on random weights; ``every_position`` runs every
    position of the mesh (the record's cost is then the whole mesh's)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape.name,
        "mesh": "multi" if multi_pod else "single",
        "mesh_shape": dict(mesh.shape), "chips": mesh.size,
        "hardware": HARDWARE,
    }
    if not shape_applicable(arch, shape, cfg):
        record["status"] = "skipped"
        record["reason"] = SKIP_REASON
        return record
    q_seq = 1 if shape.kind == "decode" else shape.seq_len
    rules = resolve_rules(mesh, M.sharding_dims(
        cfg, shape.global_batch, kv_seq=shape.seq_len, q_seq=q_seq))
    record["model_axes"] = sorted(k for k, v in rules.table.items()
                                  if MODEL_AXIS in v)
    bad = TP.unsupported_axes(cfg, rules) if mesh.size > 1 else []
    if bad:
        record["status"] = "unsupported"
        record["axes"] = bad
        record["reason"] = (f"the rules put {bad} where the port does not "
                            f"split them (ROADMAP Queue 1: what stays "
                            f"refused)")
        return record
    t0 = time.monotonic()
    info = build_program(cfg, shape, mesh, rules,
                         n_microbatches=n_microbatches, device=device,
                         seed=seed,
                         positions=None if every_position else ((0, 0),))
    record["build_seconds"] = time.monotonic() - t0
    for k in ("rows", "n_microbatches", "zero1_grads_in_scan"):
        if k in info:
            record[k] = info[k]
    if str(device) != "meta":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t1 = time.monotonic()
    counter = CostCounter()
    with counter:
        out = info["run"]()
    if str(device) != "meta":
        torch.cuda.synchronize()
        record["device_peak_bytes"] = torch.cuda.max_memory_allocated()
        record["device_held_bytes"] = base
    record["run_seconds"] = time.monotonic() - t1
    del out
    _record_cost(record, cfg, shape, counter.report, info)
    record["status"] = "ok"
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    failures = 0
    t_all = time.monotonic()
    for arch, shape in cells:
        for multi in meshes:
            mesh_name = "multi" if multi else "single"
            out_path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh_name}.json")
            if os.path.exists(out_path):
                print(f"[dryrun] SKIP (exists) {arch} {shape} {mesh_name}",
                      flush=True)
                continue
            t0 = time.monotonic()
            try:
                rec = run_cell(arch, shape, multi,
                               n_microbatches=args.microbatches)
            except Exception as e:   # the record says why; the run goes on
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            rec["wall_seconds"] = time.monotonic() - t0
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            status, extra = rec.get("status"), ""
            if status == "ok":
                mem = rec["memory_per_device"]["peak_estimate_bytes"] / 2**30
                extra = (f" peak={mem:.2f}GiB dom="
                         f"{rec['roofline']['dominant']} useful="
                         f"{rec['useful_flops_ratio']:.3f}")
            elif status == "unsupported":
                extra = f" axes={rec['axes']}"
            print(f"[dryrun] {arch} {shape} {mesh_name}: {status} "
                  f"({rec['wall_seconds']:.1f}s){extra}", flush=True)
    print(f"[dryrun] {len(cells) * len(meshes)} cells in "
          f"{time.monotonic() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
