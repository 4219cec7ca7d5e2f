"""The port's on-device preprocessing graphs
(``class_query_vad_tpu_torch/datasets/device_preprocess.py``) against the
JAX package's and against Pillow / the port's host transforms, on the
CPU.

* ``pil_axis_coeffs`` equal to JAX's; ``pil_resize_bicubic`` bit for bit
  against JAX's and ``PIL.Image.resize`` at down- and up-scales, odd
  sizes, one axis, batch axes and AVA's (400, 500) -> (256, 320);
* the HSV pair bit for bit against JAX's over random pixels and the edge
  cases (grey, each sector's boundaries, v = 0, full saturation);
* the eval and train graphs against JAX's: the uint8 stages bit for bit,
  the normalized output within 1e-6; ``draw_train_params`` and
  ``train_target_transform`` equal for the same seed; the crop clamped as
  JAX's ``dynamic_slice`` clamps it;
* the eval graph against the port's host path (PIL resize to the
  dataset's dims, ``ResizeCustom``, ``ToArray``, ``Normalize``).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from class_query_vad_tpu.datasets import device_preprocess as jdp
from class_query_vad_tpu_torch.datasets import device_preprocess as dp
from class_query_vad_tpu_torch.datasets.transforms import (
    Normalize,
    ResizeCustom,
    ToArray,
)

NORM_TOL = 1e-6
EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                   [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]], np.float32)


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("in_size,out_size", [(37, 21), (53, 33), (48, 192),
                                              (500, 320), (400, 256),
                                              (320, 341), (32, 32)])
def test_axis_coeffs_equal_jax(in_size, out_size):
    for a, b in zip(dp.pil_axis_coeffs(in_size, out_size),
                    jdp.pil_axis_coeffs(in_size, out_size)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((37, 53), (21, 33)),       # downscale, odd sizes
    ((64, 48), (256, 192)),     # upscale
    ((360, 480), (256, 341)),   # AVA-like short side down
    ((50, 70), (50, 35)),       # one axis only
    ((32, 32), (32, 32)),       # identity
    ((400, 500), (256, 320)),   # the card phase's frames
])
def test_resize_bit_exact_vs_jax_and_pillow(in_hw, out_hw):
    x = _frames(in_hw + (3,), sum(in_hw + out_hw))
    got = dp.pil_resize_bicubic(torch.from_numpy(x), out_hw)
    assert got.dtype == torch.uint8
    pil = np.asarray(Image.fromarray(x).resize((out_hw[1], out_hw[0])))
    jax_out = np.asarray(jdp.pil_resize_bicubic(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(got.numpy(), pil)
    np.testing.assert_array_equal(got.numpy(), jax_out)


def test_resize_batch_axes():
    x = _frames((2, 3, 40, 60, 3), 3)
    got = dp.pil_resize_bicubic(torch.from_numpy(x), (24, 36)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jdp.pil_resize_bicubic(jnp.asarray(x), (24, 36))))
    for b in range(2):
        for t in range(3):
            np.testing.assert_array_equal(
                got[b, t], np.asarray(Image.fromarray(x[b, t]).resize((36, 24))))


def _hsv_cases():
    """Random pixels plus the edge cases: greys (diff 0, hue table entry
    0), v = 0, each hue sector's boundaries (r, g or b the max, ties
    between two channels), full saturation, and the extremes."""
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 256, size=(4096, 3))
    g = np.arange(256)
    grey = np.stack([g, g, g], 1)
    edges = []
    for v in (1, 2, 127, 128, 254, 255):
        for lo in (0, 1, v // 2, v - 1):
            for perm in ([v, lo, lo], [lo, v, lo], [lo, lo, v], [v, v, lo],
                         [v, lo, v], [lo, v, v], [v, lo, v // 2],
                         [v // 2, v, lo], [lo, v // 2, v], [v, v // 2, lo],
                         [lo, v, v // 2], [v // 2, lo, v]):
                edges.append(perm)
    edges += [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
              [0, 0, 255], [0, 0, 1], [1, 0, 0]]
    return np.concatenate([rand, grey, np.array(edges)]).astype(np.uint8)


def test_hsv_pair_bit_exact_vs_jax():
    x = _hsv_cases()
    hsv = dp.rgb_to_hsv_u8(torch.from_numpy(x))
    want = np.asarray(jdp.rgb_to_hsv_u8(jnp.asarray(x)))
    assert hsv.dtype == torch.int32
    np.testing.assert_array_equal(hsv.numpy(), want)
    assert hsv[..., 0].max() < 180 and hsv[..., 0].min() >= 0
    # back, from the round trip and from every (h, s, v) of a coarse lattice
    lattice = np.stack(np.meshgrid(np.arange(180), np.arange(0, 256, 15),
                                   np.arange(0, 256, 15), indexing="ij"),
                       -1).reshape(-1, 3).astype(np.int32)
    for h in (want, lattice):
        got = dp.hsv_to_rgb_u8(torch.from_numpy(np.array(h)))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jdp.hsv_to_rgb_u8(jnp.asarray(h))))


def _to_uint8(normalized: np.ndarray) -> np.ndarray:
    """The uint8 stage behind a normalized output (exact: 1 LSB is
    1 / 255 / std, far above float32 rounding)."""
    x = (normalized * dp.IMAGENET_STD + dp.IMAGENET_MEAN) * 255.0
    assert np.abs(x - np.rint(x)).max() < 1e-3
    return np.rint(x).astype(np.uint8)


@pytest.mark.parametrize("native_hw", [(400, 500), (320, 400), (400, 320),
                                       (256, 341)])
def test_eval_graph_matches_jax_and_the_host_path(native_hw):
    img_size, t = 256, 3
    frames = _frames((t,) + native_hw + (3,), 11)
    fn, out_hw = dp.make_eval_preprocess(img_size, native_hw)
    jfn, jout_hw = jdp.make_eval_preprocess(img_size, native_hw)
    assert out_hw == jout_hw
    got = fn(torch.from_numpy(frames)).numpy()
    want = np.asarray(jfn(jnp.asarray(frames)))
    assert got.shape == (t,) + out_hw + (3,) and got.dtype == np.float32
    np.testing.assert_array_equal(_to_uint8(got), _to_uint8(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORM_TOL)
    # the port's host path: PIL resize to the dataset's truncated dims,
    # ResizeCustom's centre crop, ToArray, Normalize
    nw, nh = dp.resized_dims(img_size, native_hw[1], native_hw[0])
    imgs = [Image.fromarray(f).resize((nw, nh)) for f in frames]
    imgs, target = ResizeCustom(img_size)(imgs, {"size": np.array([nh, nw])})
    imgs, target = ToArray()(imgs, target)
    imgs, _ = Normalize()(imgs, target)
    np.testing.assert_allclose(got, np.stack(imgs), rtol=0, atol=NORM_TOL)


def _target(native_hw):
    boxes = np.array([[0.0, 30.0, 40.0, 200.0, 180.0],
                      [0.0, 5.0, 6.0, 90.0, 70.0]], np.float32)
    return {"size": np.array(native_hw), "boxes": boxes.copy(),
            "raw_boxes": np.concatenate([boxes[:, :1], boxes], 1)}


@pytest.mark.parametrize("native_hw,seed", [((256, 341), 0), ((341, 256), 3),
                                            ((300, 341), 7), ((400, 500), 4)])
def test_train_graph_matches_jax(native_hw, seed):
    img_size, t, jitter = 256, 2, 0.4
    frames = _frames((t,) + native_hw + (3,), 100 + seed)
    draw = dict(img_size=img_size, in_hw=native_hw, sat_shift=jitter,
                val_shift=jitter, alphastd=0.1, eigval=EIGVAL, eigvec=EIGVEC)
    params = dp.draw_train_params(np.random.default_rng(seed), **draw)
    jparams = jdp.draw_train_params(np.random.default_rng(seed), **draw)
    assert params.keys() == jparams.keys()
    for k in params:
        assert params[k].dtype == jparams[k].dtype, k
        np.testing.assert_array_equal(params[k], jparams[k], err_msg=k)
    fn, out_hw = dp.make_train_preprocess(img_size, native_hw)
    jfn, jout_hw = jdp.make_train_preprocess(img_size, native_hw)
    assert out_hw == jout_hw == dp.random_crop_dims(img_size, native_hw)
    got = fn(torch.from_numpy(frames), params).numpy()
    want = np.asarray(jfn(jnp.asarray(frames), jparams))
    assert got.shape == (t,) + out_hw + (3,)
    np.testing.assert_array_equal(_to_uint8(got), _to_uint8(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORM_TOL)
    a = dp.train_target_transform(_target(native_hw), img_size, native_hw,
                                  params)
    b = jdp.train_target_transform(_target(native_hw), img_size, native_hw,
                                   jparams)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_graph_stages_and_clamped_crop_match_jax():
    """Each flip and a negative hue shift (the mod), a PCA shift that
    wraps below 0 and above 255, and crop origins past the frame, which
    JAX's ``dynamic_slice`` (and the port) clamp to fit, a negative one
    counted once from the end first."""
    native_hw, img_size = (300, 341), 256
    frames = _frames((2,) + native_hw + (3,), 9)
    fn, _ = dp.make_train_preprocess(img_size, native_hw)
    jfn, _ = jdp.make_train_preprocess(img_size, native_hw)
    for flip, crop, pca in ((True, [11, 37], [-40.5, 3.25, 60.0]),
                            (False, [90, -5], [0.0, -300.0, 300.0]),
                            (True, [-3, 500], [-0.75, 0.5, 255.5])):
        params = {"flip": np.asarray(flip),
                  "crop_yx": np.asarray(crop, np.int32),
                  "hsv_shift": np.asarray([-10, 102, -102], np.int32),
                  "pca_rgb": np.asarray(pca, np.float32)}
        got = fn(torch.from_numpy(frames), params).numpy()
        want = np.asarray(jfn(jnp.asarray(frames), params))
        np.testing.assert_array_equal(_to_uint8(got), _to_uint8(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=NORM_TOL)


def test_bf16_output_and_device_of_the_params():
    """The graph's output dtype is the model's; the host params (numpy)
    go to the frames' device with them."""
    fn, out_hw = dp.make_eval_preprocess(64, (80, 100), dtype=torch.bfloat16)
    x = torch.from_numpy(_frames((1, 2, 80, 100, 3), 2))
    assert fn(x).dtype == torch.bfloat16 and fn(x).shape[2:4] == out_hw
    tfn, _ = dp.make_train_preprocess(64, (80, 100), dtype=torch.bfloat16)
    params = dp.draw_train_params(np.random.default_rng(1), 64, (80, 100),
                                  0.4, 0.4, 0.1, EIGVAL, EIGVEC)
    torch_params = {k: torch.as_tensor(v) for k, v in params.items()}
    np.testing.assert_array_equal(tfn(x, params).float().numpy(),
                                  tfn(x, torch_params).float().numpy())
