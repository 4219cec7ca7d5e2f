"""FLOPs of a model's forward (counterpart of the JAX package's
``utils/flops.py``, which reads XLA's cost analysis).

``torch.utils.flop_counter.FlopCounterMode`` counts the dense products
(``mm``, ``bmm``, ``addmm``, ``baddbmm``, attention) and convolutions of
one forward, 2 per multiply-add.  The hand-written kernels, launched
through ``ctypes`` on the card, are invisible to it; their plain
versions, which stand in for them on the CPU, run hidden from it
(``ops.cuda_build.plain_version``), so a count is the same on either
device, as XLA gives a Pallas call no cost.  Elementwise work is not
counted, and the port has no count of bytes accessed: the result says so
(``bytes_accessed`` None).
"""

from __future__ import annotations

import contextlib

import torch

NO_BYTES = "not counted (the port has no count of bytes accessed)"


@contextlib.contextmanager
def counting(model):
    """A ``FlopCounterMode`` (yielded) over the block, with ``model``'s
    parameters taken out of autograd meanwhile: the counter's module
    tracker hooks the gradients of inputs that need one, and a parameter
    passed to a submodule has no gradient function to hook."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    grads = [p for p in model.parameters() if p.requires_grad]
    try:
        for p in grads:
            p.requires_grad_(False)
        with torch.no_grad(), counter:
            yield counter
    finally:
        for p in grads:
            p.requires_grad_(True)


def model_cost(model, *example_args) -> dict:
    """{"flops", "bytes_accessed" (None), "note"} of ``model(*example_args)``
    in its current mode, without gradients."""
    with counting(model) as counter:
        model(*example_args)
    return {"flops": int(counter.get_total_flops()), "bytes_accessed": None,
            "note": NO_BYTES}


def count_flops(cfg, temp_len: int = 16, height: int = 256, width: int = 320,
                device=None, dtype=torch.bfloat16) -> dict:
    """``model_cost`` of the configured model (seeded init, eval mode) on
    one zero clip [1, temp_len, height, width, 3]."""
    from ..models import build_model

    model = build_model(cfg, dtype=dtype, device=device,
                        input_hw=(height, width))
    dev = next(model.parameters()).device
    pixels = torch.zeros((1, temp_len, height, width, 3), device=dev)
    mask = torch.zeros((1, height, width), dtype=torch.bool, device=dev)
    return model_cost(model, pixels, mask)
