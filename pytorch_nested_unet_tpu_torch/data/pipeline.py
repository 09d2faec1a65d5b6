"""Input pipelines (counterpart of data/pipeline.py).

`device`: the whole uint8 dataset lives on the device (`DeviceDataStore`), and
each step gathers its batch from it by index (`training/loop.py`), so the
host's only work per step is one slice of a numpy permutation.

`host`: for datasets too large for that, `HostPrefetchLoader` decodes each
batch from the files on a background thread (the image library's own threads
do the decoding, without the interpreter lock) one step ahead of the trainer.

Both draw the epoch order from one shared numpy Generator, so at equal seeds
they give the same batches in the same order. `resolve_pipeline` picks one
for `--pipeline auto`.

Data-parallel runs (parallel/mesh.py): every rank's device holds the whole
store (replicated, as the JAX package's store is) and draws the same seeded
order; each rank gathers its rows of every global batch. A rank's
`HostPrefetchLoader` decodes only its rows (`rows`).
"""

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True, drop_last: bool = True
                  ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (index array, valid count) for one epoch (reference DataLoader
    semantics: shuffle + drop_last for train, neither for val).

    Without drop_last the final short batch is padded by repeating its last
    index, so every batch has one shape; `valid` says how many are real.
    """
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        chunk = order[start:start + batch_size]
        if len(chunk) < batch_size:
            if drop_last:
                return
            pad = np.full(batch_size - len(chunk), chunk[-1], chunk.dtype)
            yield np.concatenate([chunk, pad]), len(chunk)
        else:
            yield chunk, batch_size


class DeviceDataStore:
    """A whole uint8 dataset (images (N,H,W,3), masks (N,H,W,C)) on `device`."""

    def __init__(self, images_u8: np.ndarray, masks_u8: np.ndarray, device="cuda"):
        if images_u8.dtype != np.uint8 or masks_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 images and masks, got {images_u8.dtype} "
                             f"and {masks_u8.dtype}")
        self.images = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
        self.masks = torch.from_numpy(np.ascontiguousarray(masks_u8)).to(device)
        self.n = images_u8.shape[0]

    def __len__(self):
        return self.n


class HostPrefetchLoader:
    """Decodes the batches of one epoch per iteration on a background thread,
    `prefetch` batches ahead. Yields (images_u8, masks_u8, valid) numpy
    batches of `dataset` (a data.datasets dataset) at size_hw; a decoding
    error is raised in the consumer. With `rows` (a slice of the batch), only
    those rows of each batch are decoded and yielded; `valid` stays the whole
    batch's count."""

    def __init__(self, dataset, batch_size: int, size_hw: Tuple[int, int],
                 shuffle: bool = True, drop_last: bool = True, prefetch: int = 2,
                 rng: Optional[np.random.Generator] = None, rows: slice = slice(None)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.size_hw = tuple(size_hw)
        self.shuffle = shuffle
        self.drop_last = drop_last
        # a Generator shared with the device path keeps both epoch orders equal
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.prefetch = prefetch
        self.rows = rows

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        # drawn here, in the consumer's order, as the device path draws it
        batches = list(epoch_batches(len(self.dataset), self.batch_size, self.rng,
                                     self.shuffle, self.drop_last))

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx, valid in batches:
                    imgs, msks = self.dataset.load_items(idx[self.rows], self.size_hw)
                    if not put((imgs, msks, valid)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)


def resolve_pipeline(config: dict, n_images: int, device) -> str:
    """`--pipeline auto`: stream from the host when the uint8 dataset would
    take more than a quarter of the device's memory, else keep it on the
    device (train.py:307-325). Other values pass through."""
    mode = config.get("pipeline", "device")
    if mode != "auto":
        return mode
    need = n_images * config["input_h"] * config["input_w"] * (
        config["input_channels"] + config["num_classes"])
    dev = torch.device(device)
    limit = torch.cuda.mem_get_info(dev)[1] if dev.type == "cuda" else None
    mode = "host" if limit and need > limit // 4 else "device"
    print(f"pipeline auto -> {mode} (dataset {need / 1e6:.1f} MB, device limit "
          f"{'unknown' if not limit else f'{limit / 1e6:.0f} MB'})")
    return mode
