"""Device times of this checkout's K5 (selective scan) and its backward,
K10 and K11 (the native blend) against another checkout's, in turns on one
card, at the shapes ``chip_smoke.py`` times.

    python -m class_query_vad_tpu_torch.scripts.compare_k5_k11 --against DIR

Run from this checkout's root.  DIR is the root of another checkout (a
parent commit unpacked with ``git archive``, say).  Both checkouts'
``csrc/selective_scan.cu`` and ``csrc/native_blend.cu`` are built with this
checkout's nvcc flags and called through their own C launchers (each
checkout's ``cuda_build.KERNELS`` gives the argument types; K5's launcher
took a scratch and a chunk length from this PR on) on the same inputs, in
the order other, this, this, other (CUDA events around launches queued
behind a device sleep, ``chip_smoke.kernel_device_ms``).  K5 at the VSS
path's backbone (bf16) and encoder (float32) scans, summed per VSS forward
(48 of each); K5's backward at the train path's (B=1), summed per VSS train
step (48 of each), each checkout's call with its own scratch
(``_bwd_scratch`` of its ``ops/selective_scan.py``) on this checkout's
chunk carry-ins; K10 (T=2) and K11 (T=8) bf16 at the native mode's four
query grids, summed per encoder layer.  Prints the card's name and power
limit, one line per shape, and one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke

from ..ops import cuda_build
from ..ops.fast_deform import native_tables_on
from ..ops.selective_scan import scan_carries, scan_chunk

SOURCES = ("selective_scan", "selective_scan_bwd", "native_blend2d", "native_blend3d")
ROOTS = {}                    # "this" / "other": the checkouts compare() builds


def kernel_table(root: Path) -> dict:
    """``root``'s ``cuda_build.KERNELS``, loaded from its file."""
    path = root / "class_query_vad_tpu_torch" / "ops" / "cuda_build.py"
    spec = importlib.util.spec_from_file_location(f"_cuda_build_{abs(hash(root))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.KERNELS


def scan_module(root: Path):
    """``root``'s ``ops/selective_scan.py``, loaded as a module of its own
    ``ops`` package."""
    ops = root / "class_query_vad_tpu_torch" / "ops"
    name = f"_ops_{abs(hash(str(root)))}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ops / "__init__.py", submodule_search_locations=[str(ops)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[name] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"{name}.selective_scan")


def build(root: Path, out_dir: Path, names=SOURCES) -> dict:
    """The C launchers of the kernels ``names`` (K5, K10 and K11 unless
    told) built from ``root``'s sources."""
    table = kernel_table(root)
    procs = {}
    for name in names:
        source = table[name][0]
        if source in procs:
            continue
        so = out_dir / f"lib{Path(source).stem}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
               str(root / "class_query_vad_tpu_torch" / "csrc" / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for source, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}'s {source}:\n{log}")
        libs[source] = ctypes.CDLL(str(so))
    launchers = {}
    for name in names:
        source, fn_name, argtypes = table[name]
        fn = getattr(libs[source], fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        launchers[name] = fn
    return launchers


def scan_args(fn, inputs, shape, dtype, dev, keep):
    """K5's launcher arguments (before the stream) for ``fn``'s signature:
    with a scratch and a chunk (20 arguments) or without (18)."""
    u, delta, a, bm, cm, d, bias, y = inputs
    b, kd, length, ns, g = shape
    strides = (ctypes.c_longlong * 17)(
        *u.stride(), *delta.stride(), *bm.stride(), *cm.stride(), *y.stride())
    keep.append(strides)
    head = [u.data_ptr(), delta.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), d.data_ptr(), bias.data_ptr(), y.data_ptr(), None]
    tail = [ctypes.addressof(strides), int(dtype == torch.bfloat16), b, kd,
            length, g, ns, 1]
    if len(fn.argtypes) == 18:
        return head + tail
    chunk = scan_chunk(b, kd, length, g)
    summaries = (length - 1) // chunk
    scratch = torch.empty(max(1, b * summaries * kd * (ns + 1)), dtype=torch.float32,
                          device=dev)
    keep.append(scratch)
    return head + [scratch.data_ptr()] + tail + [chunk]


def scan_bwd_args(root, inputs, shape, dtype, dev, keep):
    """K5's backward launcher arguments (before the stream) at ``shape``,
    with the scratch ``root``'s wrapper allocates."""
    u, delta, a, bm, cm, d, bias, dy, carries, dlast, outs = inputs
    b, kd, length, ns, g = shape
    chunk = scan_chunk(b, kd, length, g)
    scratch = torch.empty(scan_module(root)._bwd_scratch(b, kd, length, g, ns, chunk),
                          dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 17)(
        *u.stride(), *delta.stride(), *bm.stride(), *cm.stride(), *dy.stride())
    keep += [scratch, strides]
    return [x.data_ptr() for x in (u, delta, a, bm, cm, d, bias, dy, carries, dlast,
                                   *outs, scratch)] + [
        ctypes.addressof(strides), int(dtype == torch.bfloat16), b, kd, length, g, ns, 1,
        chunk]


def native_args(grid, t, nc, dev, keep):
    """K10 (nc=2) or K11 (nc=3) launcher arguments at one query grid over
    the native mode's four levels, B=2, bf16."""
    values, comps = chip_smoke.native_inputs(
        np.random.default_rng(13), 2, t, grid, chip_smoke.NATIVE_GRIDS, nc,
        torch.bfloat16, dev)
    h, w = grid
    base, phi = native_tables_on(h, w, tuple(chip_smoke.NATIVE_GRIDS), dev)
    out = torch.empty((2, t, h, w, 256), dtype=torch.float32, device=dev)
    keep += [*values, *comps, base, phi, out]
    return [*(v.data_ptr() for v in values), *(v.stride(0) for v in values),
            *(x.data_ptr() for x in comps), base.data_ptr(), phi.data_ptr(),
            out.data_ptr(), 1, 2, 4, t, h, w, 256]


def cases(built, dev, keep):
    """(tag, kernel, {who: launcher arguments}, (total, count per forward /
    layer))."""
    for shape, dtype in ((chip_smoke.K5_BACKBONE, torch.bfloat16),
                         (chip_smoke.K5_ENCODER, torch.float32)):
        if "selective_scan" not in built["this"]:
            break
        inputs = chip_smoke.scan_inputs(np.random.default_rng(5), shape, dtype, dev)
        inputs = (*inputs, torch.empty_like(inputs[0]))
        keep += inputs
        tag = f"K5 {'x'.join(map(str, shape))} {str(dtype)[6:]}"
        yield (tag, "selective_scan",
               {who: scan_args(built[who]["selective_scan"], inputs, shape, dtype,
                               dev, keep) for who in built},
               ("K5 per VSS forward", chip_smoke.K5_PER_FORWARD[shape]))
    for shape, dtype in ((chip_smoke.K5_TRAIN_BACKBONE, torch.bfloat16),
                         (chip_smoke.K5_TRAIN_ENCODER, torch.float32)):
        if "selective_scan_bwd" not in built["this"]:
            break
        rng = np.random.default_rng(15)
        u, delta, a, bm, cm, d, bias = chip_smoke.scan_inputs(rng, shape, dtype, dev)
        b, kd, length, ns, g = shape
        dy = torch.from_numpy(rng.standard_normal(u.shape).astype(np.float32)).to(dev).to(dtype)
        dlast = torch.zeros((b, kd, ns), device=dev)
        carries = scan_carries(u, delta, a, bm, cm, d, bias, True)
        outs = (torch.empty_like(u), torch.empty(u.shape, device=dev),
                torch.empty(bm.shape, dtype=dtype, device=dev),
                torch.empty(bm.shape, dtype=dtype, device=dev),
                torch.empty((kd, ns), device=dev), torch.empty(kd, device=dev),
                torch.empty(kd, device=dev))
        inputs = (u, delta, a, bm, cm, d, bias, dy, carries, dlast, outs)
        keep += [u, delta, a, bm, cm, d, bias, dy, carries, dlast, *outs]
        tag = f"K5 backward {'x'.join(map(str, shape))} {str(dtype)[6:]}"
        yield (tag, "selective_scan_bwd",
               {who: scan_bwd_args(ROOTS[who], inputs, shape, dtype, dev, keep)
                for who in built},
               ("K5 backward per VSS train step", chip_smoke.K5_BWD_PER_STEP[shape]))
    for k, name, nc in (("K10", "native_blend2d", 2), ("K11", "native_blend3d", 3)):
        if name not in built["this"]:
            continue
        t = chip_smoke.NATIVE_T[k]
        for grid in chip_smoke.NATIVE_GRIDS:
            args = native_args(grid, t, nc, dev, keep)
            yield (f"{k} T={t} {grid[0]}x{grid[1]}", name,
                   {who: args for who in built}, (f"{k} per encoder layer", 1))


def compare(doc: str, names, make_cases) -> dict:
    """Build ``names`` from this checkout and from ``--against``'s, then
    time every case of ``make_cases(built, dev, keep)`` — (tag, kernel,
    {who: launcher arguments}, (total or None, count)) — in turns, other,
    this, this, other; print and return the times and the totals."""
    parser = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    parser.add_argument("--against", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--kernels", nargs="+", choices=names, default=names,
                        help="time only these kernels")
    opts = parser.parse_args()
    names = opts.kernels
    if not torch.cuda.is_available():
        raise RuntimeError("the comparison needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_info()
    print(f"card: {card}")
    res = {"card": card, "shapes": {}, "totals": {}}
    ROOTS.update(this=Path.cwd(), other=opts.against.resolve())
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "this").mkdir()
        (Path(tmp) / "other").mkdir()
        built = {"this": build(Path.cwd(), Path(tmp) / "this", names),
                 "other": build(opts.against.resolve(), Path(tmp) / "other", names)}
        keep = []
        for tag, name, args, (total, count) in make_cases(built, dev, keep):
            if name not in names:
                continue
            stream = torch.cuda.current_stream().cuda_stream
            times = {"this": [], "other": []}
            for who in ("other", "this", "this", "other"):
                fn, a = built[who][name], args[who]
                err = fn(*a, stream)
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"{who} checkout's {name} failed: CUDA error {err}")
                times[who].append(chip_smoke.kernel_device_ms(lambda: fn(*a, stream)))
            res["shapes"][tag] = {"this_ms": times["this"], "other_ms": times["other"]}
            if total is not None:
                sums = res["totals"].setdefault(total, {"this_ms": 0.0, "other_ms": 0.0})
                for who in times:
                    sums[f"{who}_ms"] += count * sum(times[who]) / len(times[who])
            print(f"{tag}: this {times['this']} ms, other {times['other']} ms, "
                  f"other / this {sum(times['other']) / sum(times['this']):.2f}x")
    for total, sums in res["totals"].items():
        print(f"{total}: this {sums['this_ms']:.4f} ms, other {sums['other_ms']:.4f} ms, "
              f"other / this {sums['other_ms'] / sums['this_ms']:.2f}x")
    print(json.dumps(res))
    return res


def main() -> dict:
    return compare(__doc__, SOURCES, cases)


if __name__ == "__main__":
    main()
