"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` exposes one plain C launcher per kernel (K10 and
K11 share ``native_blend.cu``) and is compiled by ``nvcc`` for ``sm_90a``
into ``_build/lib<source>-<hash>.so`` (the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source
rebuilds), then loaded with ``ctypes``.  No PyTorch headers are compiled: a build takes seconds.
Nothing here runs at import time — the CPU tests import every module on a
machine without ``nvcc``.  The wrappers' two shared rules live here too:
``device_of`` (CPU tensors go to the plain version, CUDA tensors on one
device to the kernel, anything else raises) and ``launch`` (the C
launcher on the current stream; a non-zero CUDA error raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# kernel name -> (source under csrc/, C launcher, its ctypes argtypes)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
KERNELS = {
    # vol, fused, out, ints, radius, tile rows, tile columns
    "fused_blend2d": (
        "fused_blend2d.cu", "fused_blend2d_launch",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    # vol, dx, dy, a, out, ints, tile rows, tile columns
    "blend2d": (
        "blend2d.cu", "blend2d_launch",
        [_P] * 5 + [_I] * 9 + [_P],
    ),
    # dx, dy, a, g, dvol, ints, tile rows, tile columns, heads per block
    "blend2d_bwd_dvol": (
        "blend2d_bwd_dvol.cu", "blend2d_bwd_dvol_launch",
        [_P] * 5 + [_I] * 10 + [_P],
    ),
    # vol, dx, dy, a, g, ddx, ddy, da, ints, tile rows, tile columns, heads
    "blend2d_bwd_dcomps": (
        "blend2d_bwd_dcomps.cu", "blend2d_bwd_dcomps_launch",
        [_P] * 8 + [_I] * 10 + [_P],
    ),
    # vol, dx, dy, dt, a, out, ints, tile, frames per block
    "blend3d": (
        "blend3d.cu", "blend3d_launch",
        [_P] * 6 + [_I] * 9 + [_P],
    ),
    # dx, dy, dt, a, g, dvol, ints, tile
    "blend3d_bwd_dvol": (
        "blend3d_bwd_dvol.cu", "blend3d_bwd_dvol_launch",
        [_P] * 6 + [_I] * 8 + [_P],
    ),
    # vol, dx, dy, dt, a, g, ddx, ddy, ddt, da, ints, tile, frames per block
    "blend3d_bwd_dcomps": (
        "blend3d_bwd_dcomps.cu", "blend3d_bwd_dcomps_launch",
        [_P] * 10 + [_I] * 9 + [_P],
    ),
    # u, delta, A, B, C, D, bias, y, last, scratch, strides, ints, chunk
    "selective_scan": (
        "selective_scan.cu", "selective_scan_launch",
        [_P] * 11 + [_I] * 8 + [_P],
    ),
    # u, delta, A, B, C, D, bias, dy, carries, dlast, du, ddelta, dB, dC,
    # dA, dD, dbias, scratch, strides, ints, chunk
    "selective_scan_bwd": (
        "selective_scan_bwd.cu", "selective_scan_bwd_launch",
        [_P] * 19 + [_I] * 8 + [_P],
    ),
    # values v0..v3, their batch strides, dx, dy, a, tables, out, ints
    "native_blend2d": (
        "native_blend.cu", "native_blend2d_launch",
        [_P] * 4 + [_L] * 4 + [_P] * 6 + [_I] * 7 + [_P],
    ),
    # as K10, with dt after dy
    "native_blend3d": (
        "native_blend.cu", "native_blend3d_launch",
        [_P] * 4 + [_L] * 4 + [_P] * 7 + [_I] * 7 + [_P],
    ),
    # qkv, out, dtype, batch, n, heads, scale
    "vit_attention": (
        "vit_attention.cu", "vit_attention_launch",
        [_P, _P, _I, _I, _I, _I, _F, _P],
    ),
    # x, w1, b1, w2, b2, out, dtype, activation, n, c, f
    "fused_ffn": (
        "fused_ffn.cu", "fused_ffn_launch",
        [_P] * 6 + [_I] * 5 + [_P],
    ),
}

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_launchers: Dict[str, ctypes._CFuncPtr] = {}
build_logs: Dict[str, str] = {}      # source -> nvcc/ptxas output of this process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def library_path(name: str) -> Path:
    """The library built from kernel ``name``'s source."""
    source = KERNELS[name][0]
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, float]:
    """Compile the sources of every named kernel that are not built yet —
    one nvcc process per source, all started together.  Returns seconds per
    source compiled by this call; raises with nvcc's output on failure."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        source = KERNELS[name][0]
        out = library_path(name)
        if out.exists() or source in running:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[source] = (proc, tmp, out, time.perf_counter())
    seconds = {}
    for source, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        build_logs[source] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{log}")
        os.replace(tmp, out)
        seconds[source] = time.perf_counter() - t0
    return seconds


def launcher(name: str):
    """The C launcher of kernel ``name``, building its library if needed."""
    if name not in _launchers:
        build([name])
        _, fn_name, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return _launchers[name]


def kernel_info(name: str, *args: int) -> Dict[str, int]:
    """Registers per thread, shared memory bytes per CTA and CTAs per SM
    of kernel ``name``'s variant chosen by ``args``, as the card runs it
    (its source's C function ``<name>_info``, which K12 and K13 have)."""
    launcher(name)
    fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_info")
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    out = (_I * 3)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{name}_info failed: CUDA error {err}")
    return {"registers": out[0], "smem_bytes": out[1], "ctas_per_sm": out[2]}


def device_of(*tensors: torch.Tensor) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when all lie on one
    CUDA device; raises otherwise (the wrappers' only routing rule)."""
    devs = {x.device for x in tensors}
    if all(d.type == "cpu" for d in devs):
        return "cpu"
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return "cuda"
    raise ValueError(f"takes CPU tensors or CUDA tensors on one device; got "
                     f"{sorted(str(d) for d in devs)}")


def plain_version(stands_in: bool, fn, *args):
    """``fn(*args)``, a kernel's plain version; where it ``stands_in`` for
    the kernel (CPU tensors) it runs hidden from torch's dispatch modes:
    on the card the kernel, launched through ctypes, is invisible to them
    (``utils.flops``' ``FlopCounterMode``), so a count is the same
    whichever runs, as XLA gives a Pallas call no cost."""
    if not stands_in:
        return fn(*args)
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return fn(*args)


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C launcher on ``device``'s current stream and
    raise on a non-zero CUDA error."""
    fn = launcher(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
