"""Host-side data loader: fixed-shape packing + threaded prefetch (a copy
of the JAX package's ``datasets/loader.py``; batches stay numpy on the
host, the eval loop and ``engine.Trainer`` copy them to the device).

Every batch is packed onto a fixed canvas (CONFIG.DATA.CANVAS, default
[IMG_SIZE, 2*IMG_SIZE]) with a True-on-pad mask, in place of the
reference's per-batch ``NestedTensor`` padding (utils/misc.py:338-372), so
the encoder's kernels see one shape per config; ragged targets become
masked fixed-size arrays in the layout the criterion consumes:

* AVA:   boxes [B, M, 4] (normalized cxcywh), labels [B, M, NC],
         n_boxes [B];
* UCF/JHMDB: boxes [B, A, T, 4], labels [B, A, T], frame_valid [B, T],
         n_actors [B].

Eval metadata (image ids, raw boxes, sizes) stays host-side in ``meta``.
The last batch of an epoch is completed by repeating samples, flagged
``_fill`` so that evaluation never scores them.

Distribution: the loader shards sample indices by (host_id, num_hosts),
the counterpart of the reference's DistributedSampler
(datasets/ava_frame.py:312-332).  No dataset module (they import PIL) is
imported before ``build_dataloader`` is called.
"""

from __future__ import annotations

import inspect
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def pack_clips(clips: List[np.ndarray], canvas_hw: Tuple[int, int]):
    """[T, h, w, 3] float32 clips -> pixels [B, T, H, W, 3], mask [B, H, W]."""
    b = len(clips)
    t = clips[0].shape[0]
    H, W = canvas_hw
    pixels = np.zeros((b, t, H, W, 3), np.float32)
    mask = np.ones((b, H, W), bool)
    for i, clip in enumerate(clips):
        h, w = clip.shape[1:3]
        if h > H or w > W:
            raise ValueError(f"clip ({h},{w}) exceeds canvas {canvas_hw}")
        pixels[i, :, :h, :w] = clip
        mask[i, :h, :w] = False
    return pixels, mask


def pack_targets_ava(targets: List[Dict], max_boxes: int, num_classes: int):
    b = len(targets)
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    labels = np.zeros((b, max_boxes, num_classes), np.float32)
    n_boxes = np.zeros(b, np.int32)
    for i, t in enumerate(targets):
        n = min(len(t["boxes"]), max_boxes)
        boxes[i, :n] = t["boxes"][:n, 1:]          # drop keyframe col
        labels[i, :n] = t["labels"][:n]
        n_boxes[i] = n
    return {"boxes": boxes, "labels": labels, "n_boxes": n_boxes}


def pack_targets_frames(targets: List[Dict], max_actors: int, clip_len: int,
                        num_classes: int):
    b = len(targets)
    boxes = np.zeros((b, max_actors, clip_len, 4), np.float32)
    labels = np.full((b, max_actors, clip_len), num_classes, np.int64)
    frame_valid = np.zeros((b, clip_len), bool)
    n_actors = np.zeros(b, np.int32)
    for i, t in enumerate(targets):
        tb = t["boxes"].reshape(-1, clip_len, 5)    # [A, T, 5]
        a = min(tb.shape[0], max_actors)
        boxes[i, :a] = tb[:a, :, 1:]
        n_actors[i] = a
        lb = np.asarray(t["labels"]).reshape(-1, clip_len)
        labels[i, : min(lb.shape[0], max_actors)] = lb[:max_actors]
        fp = int(t.get("front_pad", 0))
        ep = int(t.get("end_pad", 0))
        frame_valid[i, fp : clip_len - ep] = True
    return {"boxes": boxes, "labels": labels, "frame_valid": frame_valid,
            "n_actors": n_actors}


class DataLoader:
    """Threaded prefetching loader over an index-addressable dataset.

    ``dataset.__getitem__(i, rng)`` (given a seeded per-sample generator
    where its signature takes one) / ``dataset[i]`` must return
    (clip [T, h, w, 3] float32, target dict).  What loading a sample
    raises is raised where the batches are read.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        cfg,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        host_id: int = 0,
        num_hosts: int = 1,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.drop_last = drop_last
        self.epoch = 0

        data = cfg.CONFIG.DATA
        canvas = data.get("CANVAS", None)
        if canvas:
            self.canvas = (int(canvas[0]), int(canvas[1]))
        else:
            self.canvas = (int(data.IMG_SIZE), int(2 * data.IMG_SIZE))
        self.dataset_name = data.DATASET_NAME
        self.num_classes = data.NUM_CLASSES
        self.clip_len = data.TEMP_LEN
        self.max_boxes = int(data.get("MAX_BOXES", 32))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        return idx[self.host_id :: self.num_hosts]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _pack(self, samples):
        clips = [s[0] for s in samples]
        targets = [s[1] for s in samples]
        pixels, mask = pack_clips(clips, self.canvas)
        if self.dataset_name == "ava":
            packed = pack_targets_ava(targets, self.max_boxes, self.num_classes)
        else:
            packed = pack_targets_frames(
                targets, self.max_boxes, self.clip_len, self.num_classes
            )
        batch = {"pixels": pixels, "mask": mask, **packed}
        return batch, targets

    def __iter__(self) -> Iterator[Tuple[Dict, List[Dict]]]:
        indices = self._indices()
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [(b, np.zeros(self.batch_size, bool))
                       for b in batches if len(b) == self.batch_size]
        else:
            # static shapes: repeat the last samples to fill the batch and
            # flag the fill positions so eval never scores duplicates
            out = []
            for b in batches:
                fill = np.zeros(self.batch_size, bool)
                if len(b) < self.batch_size:
                    fill[len(b):] = True
                    b = np.resize(b, self.batch_size)
                out.append((b, fill))
            batches = out

        out_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers)
        stop = threading.Event()
        takes_rng = _takes_rng(self.dataset)

        def load_one(idx_and_pos):
            pos, idx = idx_and_pos
            if not takes_rng:
                return self.dataset[int(idx)]
            rng = np.random.default_rng(
                (self.seed, self.epoch, int(idx), pos)
            )
            return self.dataset.__getitem__(int(idx), rng)

        def put(item):
            # gives up once the consumer has stopped reading
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bi, (batch_idx, fill) in enumerate(batches):
                        if stop.is_set():
                            break
                        samples = list(
                            pool.map(load_one, [(bi, i) for i in batch_idx])
                        )
                        batch, meta = self._pack(samples)
                        for i, m in enumerate(meta):
                            if fill[i]:
                                m["_fill"] = True
                        put((batch, meta))
            except Exception as e:  # raised again where batches are read
                put(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def _takes_rng(dataset) -> bool:
    """Whether ``dataset.__getitem__`` takes a second positional argument
    (the seeded per-sample ``np.random.Generator``)."""
    try:
        params = inspect.signature(dataset.__getitem__).parameters.values()
    except (TypeError, ValueError):
        return False
    kinds = [p.kind for p in params]
    return (inspect.Parameter.VAR_POSITIONAL in kinds or sum(
        k in (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD) for k in kinds) >= 2)


def build_dataloader(cfg, mode: str, host_id: int = 0, num_hosts: int = 1,
                     num_workers: int = 8) -> DataLoader:
    """Per-dataset builder dispatch (reference datasets/*_frame.py
    build_dataloader)."""
    name = cfg.CONFIG.DATA.DATASET_NAME
    if name == "ava":
        from .ava import build_dataset
    elif name == "ucf":
        from .ucf import build_dataset
    elif name == "jhmdb":
        from .jhmdb import build_dataset
    else:
        raise ValueError(f"unknown dataset {name}")
    dataset = build_dataset(cfg, mode)
    bs = (
        cfg.CONFIG.TRAIN.BATCH_SIZE if mode == "train"
        else cfg.CONFIG.VAL.BATCH_SIZE
    )
    return DataLoader(
        dataset, bs, cfg,
        shuffle=(mode == "train"),
        num_workers=num_workers,
        host_id=host_id, num_hosts=num_hosts,
        drop_last=(mode == "train"),
    )
