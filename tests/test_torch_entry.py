"""The port's entry points (``class_query_vad_tpu_torch/entry.py``, the
counterpart of ``__graft_entry__.py``):

* ``dryrun_multichip(2)``: two gloo ranks on the CPU take the exact-encoder
  and the ``fast_attention`` / 2d train steps (each rank's parameters after
  the update bit-equal, and within AdamW's first-step size of a
  single-process step on the whole batch) and the sharded eval on ground
  truth canned from the model's own detections (mAP above 0.005 and equal
  to the single-rank run's);
* ``entry()`` builds the main path on the card: without one it raises.
"""

import pytest
import torch

from class_query_vad_tpu_torch.entry import dryrun_multichip, entry

import torch_parity  # noqa: F401  (one torch thread per test worker)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    dryrun_multichip(2)
    out = capsys.readouterr().out
    for line in ("dryrun_multichip (exact) OK", "(fast_attention/2d) OK",
                 "eval OK", "ran on 2 CPU ranks, backend gloo"):
        assert line in out, out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        entry()
