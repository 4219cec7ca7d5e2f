"""Device times of this checkout's K12 and K13 (bf16) against another
checkout's, in turns on one card, at the shapes ``chip_smoke.py`` times.

    python -m class_query_vad_tpu_torch.scripts.compare_k12_k13 --against DIR

Run from this checkout's root.  DIR is the root of another checkout (a
parent commit unpacked with ``git archive``, say).  Both checkouts'
``csrc/vit_attention.cu`` and ``csrc/fused_ffn.cu`` are built with this
checkout's nvcc flags and called through their C launchers, whose
arguments are the same in both, on the same bf16 inputs, in the order
other, this, this, other (CUDA events around launches queued behind a
device sleep, ``chip_smoke.kernel_device_ms``).  Beside them, the library
call that computes the same function (``scaled_dot_product_attention``,
the ``F.linear`` pair).  Prints the card's name and power limit, one line
per shape, and one JSON object.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke

from ..ops import cuda_build
from ..ops.fused_ffn import ACTIVATIONS
from .bench_vit_attn import sdpa_attention

SOURCES = ("vit_attention", "fused_ffn")


def build(root: Path, out_dir: Path) -> dict:
    """The C launchers of K12 and K13 built from ``root``'s sources."""
    procs = {}
    for name in SOURCES:
        source = root / "class_query_vad_tpu_torch" / "csrc" / cuda_build.KERNELS[name][0]
        so = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    launchers = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}'s {name}:\n{log}")
        _, fn_name, argtypes = cuda_build.KERNELS[name]
        fn = getattr(ctypes.CDLL(str(so)), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        launchers[name] = fn
    return launchers


def cases(dev):
    """(tag, kernel name, launcher arguments before the stream, library
    call) at the timed shapes, inputs seeded."""
    g = torch.Generator().manual_seed(8)
    bf16 = torch.bfloat16
    for b, n, heads in (chip_smoke.K12_SHAPE, chip_smoke.K12_LONG):
        qkv = torch.randn((b, n, 3 * heads * 64), generator=g).to(dev, bf16)
        out = torch.empty((b, n, heads * 64), device=dev, dtype=bf16)
        yield (f"K12 B={b} N={n}", "vit_attention",
               (qkv.data_ptr(), out.data_ptr(), 1, b, n, heads, chip_smoke.K12_SCALE),
               lambda qkv=qkv, heads=heads: sdpa_attention(qkv, chip_smoke.K12_SCALE, heads),
               (qkv, out))
    for tag, (n, c, f, act) in chip_smoke.K13_SHAPES.items():
        args = chip_smoke.ffn_inputs(g, n, c, f, bf16, dev)
        out = torch.empty((n, c), device=dev, dtype=bf16)
        yield (f"K13 {tag}", "fused_ffn",
               (*(a.data_ptr() for a in args), out.data_ptr(), 1,
                ACTIVATIONS.index(act), n, c, f),
               chip_smoke.ffn_library(*args, act), (*args, out))


def main() -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, required=True,
                        help="root of the other checkout")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("compare_k12_k13 needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_info()
    print(f"card: {card}")
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "this").mkdir()
        (Path(tmp) / "other").mkdir()
        built = {"this": build(Path.cwd(), Path(tmp) / "this"),
                 "other": build(opts.against.resolve(), Path(tmp) / "other")}
        res = {"card": card, "shapes": {}}
        for tag, name, args, library, _keep in cases(dev):
            stream = torch.cuda.current_stream().cuda_stream
            times = {"this": [], "other": []}
            for who in ("other", "this", "this", "other"):
                fn = built[who][name]
                err = fn(*args, stream)
                torch.cuda.synchronize()
                if err != 0 and who == "this":
                    raise RuntimeError(f"this checkout's {name} failed: CUDA error {err}")
                # the other checkout may refuse the shape (K12's first
                # version took N up to 3296): no time
                times[who].append(None if err != 0 else
                                  chip_smoke.kernel_device_ms(lambda: fn(*args, stream)))
            lib = chip_smoke.kernel_device_ms(library)
            res["shapes"][tag] = {"this_ms": times["this"], "other_ms": times["other"],
                                  "library_ms": lib}
            print(f"{tag}: this {times['this']} ms, other {times['other']} ms, "
                  f"library {lib:.4f} ms")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
