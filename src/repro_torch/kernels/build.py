"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``_build/`` next to this file (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -shared -Xcompiler -fPIC -Xptxas -v [EXTRA_FLAGS[name]]
         -o _build/<name>-<hash>.so

``sim_step`` adds ``-fmad=false``: it keeps every multiply and add
separately rounded, as PyTorch's elementwise kernels round them, so that
kernel can equal its plain PyTorch version bit for bit.  ``ssd_scan`` is
held to a stated tolerance instead and keeps nvcc's default fused
multiply-adds.  ``ckpt_quant`` rounds every operation on its own by its
intrinsics (``__fdiv_rn``, ``__fmul_rn``, ``rintf``) and needs no flag.
``flash_attention`` is held to a stated tolerance and keeps the default
flags.  ``SOURCES`` lists every source.  The file name carries a hash of
the source and the flags, so an edited source is rebuilt.  ``BUILD_LOG[name]`` keeps the build
seconds and the ``-Xptxas -v`` report (registers, spills).

Every wrapper launches through :func:`launch`, which makes the operands'
device current for the call: the CUDA runtime launches on its current
device, which need not be the one a shard lives on (``cuda:1``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"sim_step": ("-fmad=false",)}
SOURCES = ("sim_step", "ssd_scan", "ckpt_quant", "flash_attention")

BUILD_LOG: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Sequence[str]) -> None:
    """Compile every named source that is not built yet, all at once (one
    nvcc process per source, started together)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "(cached)",
                                        "path": str(out)})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, time.monotonic(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, t0, proc in jobs:
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        tmp.replace(out)
        BUILD_LOG[name] = {"seconds": seconds, "ptxas": log.strip(),
                           "path": str(out)}
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def launch(fn: Callable[..., int], device: torch.device, *args) -> int:
    """``fn(*args, stream)`` -- a library's C launch function -- with
    ``device`` current and its current stream as the last argument;
    returns the function's error code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
