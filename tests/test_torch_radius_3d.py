"""A tiny whole model with ``FAST_RADIUS: 2`` and the 3d window in the
PyTorch port against the JAX package, on the CPU in float32: the heads,
and the route (the general blend, never K1, K2 or K6).  The 2d window's
model and the blend itself are in ``tests/test_torch_radius.py``; the two
files each take one JAX compile of ~50 s and run on separate xdist
workers.
"""

from test_torch_radius import check_radius2_model


def test_tiny_radius2_model_3d_matches_jax_on_the_general_route(monkeypatch):
    check_radius2_model("3d", monkeypatch)
