"""The port's datasets, transforms, loader and native decoder
(``class_query_vad_tpu_torch/datasets/``) against the JAX package's on
synthetic worlds written here: AVA (csv + JPEG frame dirs), UCF101-24
(``UCF101v2-GT.pkl`` + JPEG) and JHMDB51-21 (``JHMDB-GT.pkl`` + PNG, as
``tests/test_e2e_cli.py``'s world) at 60x80.  Items in train and val mode
from one seeded ``np.random.Generator``, with the native decoder and with
PIL, and the ``DataLoader``'s batches, meta and ``_fill`` flags over two
epochs must be equal bit for bit; the port's native binding must equal
the JAX package's on the same files (both skip where the JAX package's
decoder is unavailable); ``pad_clips_to_shape`` packs as JAX's does;
importing the loader and the engine loads neither PIL nor cv2."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_equal
from PIL import Image

import class_query_vad_tpu.datasets.native_decode as jnd
import class_query_vad_tpu_torch.datasets.native_decode as tnd
from class_query_vad_tpu.config import get_cfg_defaults as jax_defaults
from class_query_vad_tpu_torch.config import get_cfg_defaults as port_defaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(path, n, rng, ext):
    os.makedirs(path, exist_ok=True)
    for i in range(1, n + 1):
        arr = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(path, f"{i:05d}.{ext}"),
                                  quality=95)


def _ava_world(root, rng):
    for vid in ("vidA", "vidB"):
        _frames(str(root / "frames" / vid), 40, rng, "jpg")
    os.makedirs(root / "annotations")
    for mode in ("train", "val"):
        rows = []
        for vid, sec, n in (("vidA", 901, 2), ("vidA", 902, 1),
                            ("vidB", 901, 3)):
            for _ in range(n):
                x1, y1 = rng.uniform(0.05, 0.5, 2)
                rows.append(f"{vid},{sec:04d},{x1:.3f},{y1:.3f},"
                            f"{x1 + 0.3:.3f},{y1 + 0.4:.3f},"
                            f"{int(rng.integers(1, 13))}\n")
        (root / "annotations" / f"ava_{mode}_v2.2.csv").write_text(
            "".join(rows))
    return dict(DATASET_NAME="ava", DATA_PATH=str(root), NUM_CLASSES=12,
                TEMP_LEN=4, FRAME_RATE=2)


def _tube_world(root, rng, name):
    nc = 24 if name == "ucf" else 21
    vids = [f"Cls/v_{i:04d}" for i in range(3)]
    nframes = dict(zip(vids, (19, 8, 11) if name == "ucf" else (10, 8, 6)))
    gttubes = {}
    for v in vids:
        n = nframes[v]
        start = int(rng.integers(1, 4)) if name == "ucf" else 1
        length = int(rng.integers(4, n - start + 1)) if name == "ucf" else n
        tubes = []
        for _ in range(2 if name == "ucf" else 1):
            rows = []
            for f in range(start, start + length):
                x1, y1 = rng.uniform(2, 30, 2)
                rows.append([f, x1, y1, x1 + 25, y1 + 20])
            tubes.append(np.array(rows))
        gttubes[v] = {int(rng.integers(0, nc)): tubes}
        _frames(str(root / v), n, rng, "jpg" if name == "ucf" else "png")
    fname = "UCF101v2-GT.pkl" if name == "ucf" else "JHMDB-GT.pkl"
    with open(root / fname, "wb") as f:
        pickle.dump({"labels": [str(i) for i in range(nc)],
                     "train_videos": [vids] * 3, "test_videos": [vids] * 3,
                     "nframes": nframes,
                     "resolution": {v: (60, 80) for v in vids},
                     "gttubes": gttubes}, f)
    return dict(DATASET_NAME=name, DATA_PATH=str(root), ANNO_PATH=str(root),
                NUM_CLASSES=nc, TEMP_LEN=8 if name == "ucf" else 12)


WORLDS = {"ava": _ava_world, "ucf": lambda r, g: _tube_world(r, g, "ucf"),
          "jhmdb": lambda r, g: _tube_world(r, g, "jhmdb")}


def _cfgs(data: dict, native: bool):
    out = []
    for defaults in (jax_defaults, port_defaults):
        cfg = defaults()
        for k, v in data.items():
            setattr(cfg.CONFIG.DATA, k, v)
        cfg.CONFIG.MODEL.TEMP_LEN = data["TEMP_LEN"]
        cfg.CONFIG.DATA.IMG_SIZE = 64
        cfg.CONFIG.DATA.MAX_BOXES = 4
        cfg.CONFIG.DATA.NATIVE_DECODE = native
        cfg.CONFIG.TRAIN.BATCH_SIZE = 2
        cfg.CONFIG.VAL.BATCH_SIZE = 2
        out.append(cfg)
    return out


def _build(pkg, name, cfg, mode):
    mod = __import__(f"{pkg}.datasets.{name}", fromlist=["build_dataset"])
    return mod.build_dataset(cfg, mode)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    rng = np.random.default_rng(0)
    return {k: f(tmp_path_factory.mktemp(k), rng) for k, f in WORLDS.items()}


def _native_cases():
    return [True, False] if jnd.available() else [False]


@pytest.mark.parametrize("native", _native_cases())
@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", ["ava", "ucf", "jhmdb"])
def test_dataset_items(worlds, name, mode, native):
    jcfg, tcfg = _cfgs(worlds[name], native)
    jds = _build("class_query_vad_tpu", name, jcfg, mode)
    tds = _build("class_query_vad_tpu_torch", name, tcfg, mode)
    assert len(jds) == len(tds) > 1
    for i in range(len(jds)):
        seed = 100 + i
        jclip, jt = jds.__getitem__(i, np.random.default_rng(seed))
        tclip, tt = tds.__getitem__(i, np.random.default_rng(seed))
        assert tclip.dtype == np.float32 and tclip.ndim == 4
        assert_equal(tclip, jclip)
        assert_equal(tt, jt)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", ["ava", "jhmdb"])
def test_dataloader_batches(worlds, name, mode):
    from class_query_vad_tpu.datasets.loader import build_dataloader as jbuild
    from class_query_vad_tpu_torch.datasets import build_dataloader as tbuild

    jcfg, tcfg = _cfgs(worlds[name], jnd.available())
    # one worker: the datasets number their samples in the order they load
    # them (raw_boxes' first column, ``index_cnt``, as the reference does),
    # which several workers make racy in either package
    jl = jbuild(jcfg, mode, num_workers=1)
    tl = tbuild(tcfg, mode, num_workers=1)
    assert tl.canvas == jl.canvas and len(tl) == len(jl) > 0
    fills = 0
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(jl)
        for (jbatch, jmeta), (tbatch, tmeta) in zip(jb, tb):
            assert_equal(tbatch, jbatch)
            assert_equal(tmeta, jmeta)
            fills += sum(bool(m.get("_fill")) for m in tmeta)
    # val: 3 samples in batches of 2 complete the last batch with a fill
    assert fills == (2 if mode == "val" else 0)


class _Raising:
    """A dataset whose every item raises ``exc`` (a decoder that cannot
    open the file)."""

    def __init__(self, exc):
        self.exc = exc

    def __len__(self):
        return 4

    def __getitem__(self, index, rng):
        raise self.exc(f"cannot decode item {index}")


@pytest.mark.parametrize("exc", [OSError, TypeError])
def test_dataloader_raises_what_loading_raises(exc):
    """The loader raises the dataset's own error where the batches are
    read, neither hanging nor retrying without the seeded generator."""
    import threading

    from class_query_vad_tpu_torch.datasets import DataLoader

    loader = DataLoader(_Raising(exc), 2, port_defaults(), num_workers=2)
    caught = []

    def read():
        try:
            list(loader)
        except Exception as e:
            caught.append(e)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout=30)
    assert not reader.is_alive(), "the loader hangs on a failed item"
    assert len(caught) == 1 and type(caught[0]) is exc
    assert str(caught[0]).startswith("cannot decode item")


@pytest.mark.skipif(not jnd.available(),
                    reason="the JAX package's native decoder is unavailable")
def test_native_binding_matches(tmp_path, rng):
    assert tnd.available()
    path = tnd.lib_path()
    assert path.parent.name == "_build" and path.exists()
    assert path.parent.parent.name == "class_query_vad_tpu_torch"
    paths = []
    for ext in ("jpg", "png"):
        _frames(str(tmp_path / ext), 3, rng, ext)
        paths += [str(tmp_path / ext / f"{i:05d}.{ext}") for i in (1, 2, 3)]
    for oh, ow in ((64, 85), (30, 40), (90, 120)):
        assert_equal(tnd.decode_resize(paths[0], ow, oh),
                     jnd.decode_resize(paths[0], ow, oh))
        assert_equal(tnd.decode_batch(paths, ow, oh, 2),
                     jnd.decode_batch(paths, ow, oh, 2))
        img = rng.integers(0, 255, (57, 71, 3), dtype=np.uint8)
        assert_equal(tnd.resize(img, ow, oh), jnd.resize(img, ow, oh))
    assert tnd.decode_resize(str(tmp_path / "missing.jpg"), 8, 8) is None


def test_pad_clips_to_shape(rng):
    from class_query_vad_tpu.utils.misc import pad_clips_to_shape as jpad
    from class_query_vad_tpu_torch.utils.misc import pad_clips_to_shape

    clips = [rng.normal(size=(4, h, w, 3)).astype(np.float32)
             for h, w in ((16, 24), (12, 24), (16, 20))]
    got, want = pad_clips_to_shape(clips, 16, 32), jpad(clips, 16, 32)
    assert (got.batch, got.temporal) == (3, 4) and got.pixels.device.type == "cpu"
    assert_equal(got.pixels.numpy(), np.asarray(want.pixels))
    assert_equal(got.mask.numpy(), np.asarray(want.mask))
    with pytest.raises(ValueError):
        pad_clips_to_shape(clips, 8, 32)


def test_loader_and_engine_import_no_pil_or_cv2():
    code = ("import sys\n"
            "import class_query_vad_tpu_torch.datasets.loader\n"
            "import class_query_vad_tpu_torch.engine.evaluate\n"
            "import class_query_vad_tpu_torch.engine.checkpoint\n"
            "import class_query_vad_tpu_torch.evaluates\n"
            "bad = [m for m in ('PIL', 'cv2', 'jax') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
