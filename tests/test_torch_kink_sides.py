"""``chip_smoke.py``'s kink matching for its card-vs-CPU train checks: the
float32 hat codes see the ties that rounding makes, and ``KinkSides``
zeroes, on both runs alike, the gradient of exactly the activations whose
two forwards lie on two sides of a kink."""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from chip_smoke import KinkSides, hat_codes
from class_query_vad_tpu_torch.models.backbone import MaxPool2x
from class_query_vad_tpu_torch.models.deform_encoder import MSDeformAttn3D
from class_query_vad_tpu_torch.models.fast_encoder import FastDeformAttn3D

TAPS = (-1, 0, 1)


@pytest.mark.parametrize("a, b, same", [
    (1e-8, 2e-8, True),      # fl(p + 1) = 1 and fl(p - 1) = -1: both ties
    (1e-8, 1e-6, False),     # 1 + 1e-6 is no tie
    (0.0, 1e-8, False),      # the 0 tap's own kink
    (-0.5, -0.25, True),
    (0.999, 1.0, False),
    (1.0, 1.0, True),
])
def test_hat_codes_see_float32_ties(a, b, same):
    codes = hat_codes(torch.tensor([a, b], dtype=torch.float32), TAPS)
    assert bool(codes[0] == codes[1]) is same


class _Relu(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear1 = nn.Linear(4, 3)

    def forward(self, x):
        return F.relu(self.linear1(x)).sum(0) @ torch.tensor([1.0, 2.0, 3.0])


class _Pool(nn.Module):
    def __init__(self):
        super().__init__()
        self.pool = MaxPool2x()

    def forward(self, x):
        return (self.pool(x) * torch.arange(1.0, 3.0)).sum()


def _matched_grads(model, xa, xb, active: bool = True):
    """Two copies of ``model``, both forwards, kink sides matched, both
    backwards (masked when ``active``): (counts, grad a, grad b) with
    respect to the inputs."""
    runs = []
    for x in (xa, xb):
        x = x.clone().requires_grad_()
        sides, m = KinkSides(), copy.deepcopy(model)
        sides.watch(m)
        runs.append((m(x), x, sides))
    counts = runs[0][2].match(runs[1][2])
    grads = []
    for out, x, sides in runs:
        sides.active = active
        out.backward()
        grads.append(x.grad)
    return counts, *grads


def test_kink_sides_zero_a_relu_flip_on_both_runs():
    torch.manual_seed(0)
    model = _Relu()
    with torch.no_grad():
        model.linear1.weight.copy_(torch.eye(3, 4))
        model.linear1.bias.zero_()
    xa = torch.tensor([[1e-7, 0.5, -0.5, 0.3], [0.2, -0.1, 0.4, 0.0]])
    xb = xa.clone()
    xb[0, 0] = -1e-7                      # unit 0 of row 0 crosses the kink
    counts, ga, gb = _matched_grads(model, xa, xb)
    assert counts == {"ReLU": 1}
    torch.testing.assert_close(ga, gb, rtol=0, atol=0)
    # unit 0 of row 0 carries no gradient on either run; the rest do
    assert ga[0, 0] == 0 and ga[1, 0] == 1.0 and ga[0, 1] == 2.0


def test_kink_sides_zero_a_max_pool_argmax_flip():
    xa = torch.zeros((1, 1, 2, 4, 2))
    xa[0, 0, 0, 0, 0] = 1.0
    xa[0, 0, 1, 1, 0] = 1.0 - 1e-7       # window 0, channel 0: a near tie
    xa[0, 0, 0, 2, 1] = 3.0
    xb = xa.clone()
    xb[0, 0, 1, 1, 0] = 1.0 + 1e-7       # ... whose argmax flips in run b
    model = _Pool()
    counts, ga, gb = _matched_grads(model, xa, xb)
    assert counts == {"max pool": 1}
    torch.testing.assert_close(ga, gb, rtol=0, atol=0)
    assert ga[0, 0, 0, 0, 0] == 0 and ga[0, 0, 1, 1, 0] == 0
    assert ga[0, 0, 0, 2, 1] == 2.0      # the other windows keep theirs


def test_kink_sides_mask_nothing_between_equal_runs():
    torch.manual_seed(1)
    model = _Relu()
    x = torch.randn(5, 4)
    counts, ga, gb = _matched_grads(model, x, x)
    assert counts == {"ReLU": 0}
    x = x.clone().requires_grad_()
    model(x).backward()
    torch.testing.assert_close(ga, x.grad, rtol=0, atol=0)


class _Attn(nn.Module):
    """One encoder attention over a 4x4 and a 2x2 level whose offset lane
    0 (level 0, x, head 0, point 0) reads channel 0 of the tokens alone."""

    SHAPES = ((1, 4, 4), (1, 2, 2))

    def __init__(self, cross_level):
        super().__init__()
        self.attn = FastDeformAttn3D(32, 2, 8, 2, cross_level=cross_level)
        with torch.no_grad():
            self.attn.window_offsets.weight.zero_()
            self.attn.window_offsets.bias.zero_()
            self.attn.window_offsets.weight[0, 0] = 1.0
        self.register_buffer("cot", torch.randn(1, 20, 32))

    def forward(self, src):
        out = self.attn(src, torch.zeros_like(src), self.SHAPES, None)
        return (out * self.cot).sum()


@pytest.mark.parametrize("cross_level", ["resample", "native"])
def test_kink_sides_zero_a_head_lane_crossing_its_tap(cross_level):
    """Token 0 lies on level 0's own grid (native phase 0), so its offset
    lane 0 crosses the 0 tap's kink when channel 0 changes sign."""
    torch.manual_seed(2)
    model = _Attn(cross_level)
    xa = torch.randn(1, 20, 32)
    xa[0, 0, 0] = 1e-7
    xb = xa.clone()
    xb[0, 0, 0] = -1e-7
    counts, ga, gb = _matched_grads(model, xa, xb)
    assert counts == {"head lanes": 1}
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-6)
    _, ga, gb = _matched_grads(model, xa, xb, active=False)
    assert (ga - gb).abs().max() > 1e-3


class _Exact(nn.Module):
    """The exact encoder's attention over a 4x4 and a 2x2 level: every
    sampling coordinate on a whole pixel (loc * size - 0.5 = 1), and the x
    offset of token 0's head 0, level 0, point 0 reading channel 0 of the
    token alone (divided by T = 1, the reference's (T, W, H) normaliser)."""

    SHAPES = ((1, 4, 4), (1, 2, 2))

    def __init__(self):
        super().__init__()
        self.attn = MSDeformAttn3D(32, 2, 8, 2)
        with torch.no_grad():
            self.attn.sampling_offsets.weight.zero_()
            self.attn.sampling_offsets.bias.zero_()
            self.attn.sampling_offsets.weight[0, 0] = 1.0
        ref = torch.tensor([[1.5 / 4, 1.5 / 4, 0.5], [1.5 / 2, 1.5 / 2, 0.5]])
        self.register_buffer("ref", ref.expand(1, 20, 2, 3).contiguous())
        self.register_buffer("cot", torch.randn(1, 20, 32))

    def forward(self, src):
        out = self.attn(src, self.ref, src, self.SHAPES)
        return (out * self.cot).sum()


def test_kink_sides_zero_a_sampling_coordinate_crossing_a_pixel():
    """Token 0's x coordinate 1 + 4e-7 floors to 1 in one run, 1 - 4e-7 to
    0 in the other: its gradient (the trilinear weight's kink) is zeroed on
    both, and without the matching the two runs differ there."""
    torch.manual_seed(3)
    model = _Exact()
    xa = torch.randn(1, 20, 32)
    xa[0, 0, 0] = 1e-7
    xb = xa.clone()
    xb[0, 0, 0] = -1e-7
    counts, ga, gb = _matched_grads(model, xa, xb)
    assert counts == {"trilinear floors": 1}
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-6)
    _, ga, gb = _matched_grads(model, xa, xb, active=False)
    assert (ga - gb).abs().max() > 1e-3
