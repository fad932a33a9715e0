"""ImageNet-scale streaming loader: a folder tree of JPEG/PNG files, the
port's copy of ``glom_tpu/training/image_stream.py``.

It yields the batches ``glom_tpu``'s stream yields, from the same files, in
the same order, with the same two-integer cursor.  Design:

  * **Sharded reads** — each process sees ``files[process_index::count]``;
    no coordination, no overlap, works for any process count (the port
    trains in one process, the default ``0`` of ``1``).
  * **Deterministic + exactly resumable** — iteration order is a pure
    function of ``(seed, epoch)`` (one permutation per epoch) and a position
    cursor.  ``state_dict()`` is two integers; restoring them resumes the
    stream on the exact next batch, including across process restarts.  The
    cursor snapshots account for in-flight prefetched batches, so what you
    checkpoint is the next batch the *consumer* would have seen, not the
    producer's read-ahead.
  * **Overlapped decode** — a thread pool decodes each batch's files in
    parallel (cv2 if present, else PIL; both release the GIL in the codec)
    and ``prefetch`` whole batches are kept in flight ahead of the consumer,
    so host decode overlaps device compute without a separate DataLoader
    process tree.  Where neither cv2 nor PIL imports, a JPEG decodes in the
    native core (``glom_tpu_torch.native``, libjpeg, bilinear).
  * **Static shapes** — shorter-side resize + center crop to
    ``image_size``²; partial trailing batches are dropped (epoch boundary),
    keeping every batch ``(B, C, S, S)``.

Batches are NCHW float32 numpy arrays in [-1, 1], matching the rest of the
pipeline (``glom_tpu_torch.training.data``).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_image_files(root: str) -> list:
    """Recursive, sorted scan — the sort makes the file index stable across
    processes and restarts (the shard + shuffle math depends on it)."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for f in sorted(filenames):
            if f.lower().endswith(IMAGE_EXTENSIONS):
                out.append(os.path.join(dirpath, f))
    return out


def _decode_native(path: str, image_size: int) -> np.ndarray:
    """One JPEG through the native core's libjpeg decoder; the decoder of
    last resort, where neither cv2 nor PIL imports."""
    from glom_tpu_torch import native

    if not native.has_jpeg():
        raise RuntimeError(
            f"cannot decode {path}: no image decoder is available (cv2 and PIL do not "
            f"import, and the native core glom_tpu_torch.native has no libjpeg)")
    return native.decode_jpeg_batch([path], image_size, 1)[0]


def _decode(path: str, image_size: int, channels: int) -> np.ndarray:
    """Decode + shorter-side resize + center crop -> (C, S, S) float32 in
    [-1, 1]: cv2, else PIL, else the native core's libjpeg."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR uint8, HWC
        if img is None:
            raise ValueError(f"undecodable image: {path}")
        h, w = img.shape[:2]
        scale = image_size / min(h, w)
        if scale != 1.0:
            img = cv2.resize(
                img, (max(image_size, round(w * scale)),
                      max(image_size, round(h * scale))),
                interpolation=cv2.INTER_AREA if scale < 1.0 else cv2.INTER_LINEAR,
            )
        img = img[:, :, ::-1]  # BGR -> RGB
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            arr = _decode_native(path, image_size)
            if channels != 3:
                raise ValueError(
                    f"image stream decodes RGB (3 channels), model wants {channels}")
            return arr

        with Image.open(path) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = image_size / min(h, w)
            if scale != 1.0:
                im = im.resize(
                    (max(image_size, round(w * scale)), max(image_size, round(h * scale)))
                )
            img = np.asarray(im)
    h, w = img.shape[:2]
    y0, x0 = (h - image_size) // 2, (w - image_size) // 2
    img = img[y0:y0 + image_size, x0:x0 + image_size]
    arr = np.ascontiguousarray(img.transpose(2, 0, 1), dtype=np.float32)
    arr = arr / 127.5 - 1.0
    if channels != 3:
        raise ValueError(f"image stream decodes RGB (3 channels), model wants {channels}")
    return arr


def labels_from_paths(files) -> "tuple[np.ndarray, list]":
    """Class labels from the standard ImageFolder layout (label = immediate
    parent directory name).  Returns ``(labels int64, class_names)``."""
    parents = [os.path.basename(os.path.dirname(f)) for f in files]
    names = sorted(set(parents))
    index = {n: i for i, n in enumerate(names)}
    return np.asarray([index[p] for p in parents], np.int64), names


def load_images(files, image_size: int, *, channels: int = 3, workers: int = 8) -> np.ndarray:
    """Decode a fixed file list into one ``(N, C, S, S)`` float32 array
    (eval sets — bounded, held in host RAM)."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        parts = list(pool.map(lambda p: _decode(p, image_size, channels), files))
    return np.stack(parts)


class ImageFolderStream:
    """Endless batch iterator over a folder tree of images.

    ``state_dict()``/``load_state_dict()`` capture/restore the iteration
    cursor; the Trainer checkpoints them alongside the training state so a
    resumed run continues mid-epoch on the exact next batch.  ``close()``
    (or the context manager) shuts the decode pools down.
    """

    def __init__(
        self,
        root: str,
        batch_size: int,
        image_size: int,
        *,
        channels: int = 3,
        seed: int = 0,
        shuffle: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        workers: int = 8,
        prefetch: int = 4,
        files: Optional[Sequence[str]] = None,
        native_decode: Optional[bool] = None,
    ):
        """``native_decode``: decode whole batches in the C++ core (libjpeg,
        its own thread pool, zero Python per image — scales with cores where
        the per-file Python path saturates on dispatch overhead).  Default
        auto: used when the native core is jpeg-linked, the model wants RGB,
        and every file is a .jpg/.jpeg; pass False to force the Python
        decoders (cv2/PIL)."""
        all_files = list(files) if files is not None else list_image_files(root)
        if not all_files:
            raise FileNotFoundError(f"no image files under {root}")
        self.files = all_files[process_index::process_count]
        if len(self.files) < batch_size:
            raise ValueError(
                f"process shard has {len(self.files)} images < batch_size "
                f"{batch_size} (dataset {len(all_files)} files over "
                f"{process_count} processes)"
            )
        self.batch_size = batch_size
        self.image_size = image_size
        self.channels = channels
        self.seed = seed
        self.shuffle = shuffle
        self._epoch = 0
        self._pos = 0
        self._perm = self._epoch_perm(0)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._workers = workers
        self._prefetch = max(1, prefetch)
        self._pending: deque = deque()  # (state_before, batch result getter)
        if native_decode is None or native_decode:
            candidate = (
                channels == 3
                and all(f.lower().endswith((".jpg", ".jpeg")) for f in self.files)
            )
            if native_decode:
                from glom_tpu_torch import native

                if not (candidate and native.has_jpeg()):
                    raise ValueError(
                        "native_decode=True but the native jpeg path is unusable "
                        "(needs channels=3, all-.jpg/.jpeg files, and a "
                        "libjpeg-linked native core); pass native_decode=None "
                        "for auto-fallback or False for the python decoders"
                    )
                native_decode = True
            else:
                # auto: defer the has_jpeg() probe to the first batch — its
                # first call may pay the one-time native build (two g++
                # attempts, up to 120s each), which must not land in the
                # constructor of users who never pull a batch
                native_decode = None if candidate else False
        # True | False | None = auto-undecided until the first __next__
        self._native_decode = native_decode
        if self._native_decode:
            self._native_pool = self._make_native_pool()

    @staticmethod
    def _make_native_pool() -> ThreadPoolExecutor:
        # ONE native batch call in flight at a time: the C++ core
        # parallelizes internally (capped at `workers` threads), so a
        # wider slot count would multiply thread usage, not throughput
        return ThreadPoolExecutor(max_workers=1)

    # -- determinism / resume --------------------------------------------
    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.files))
        return np.random.default_rng((self.seed, epoch)).permutation(len(self.files))

    def state_dict(self) -> dict:
        """Cursor of the next batch the CONSUMER will receive (in-flight
        prefetched batches belong to the future, so the first pending
        entry's pre-state is the resume point)."""
        if self._pending:
            epoch, pos = self._pending[0][0]
        else:
            epoch, pos = self._epoch, self._pos
        return {"epoch": epoch, "pos": pos}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._perm = self._epoch_perm(self._epoch)
        self._pending.clear()  # drop read-ahead from the pre-restore cursor

    # -- iteration --------------------------------------------------------
    def _advance(self):
        """Claim the next batch's paths at the producer cursor."""
        if self._pos + self.batch_size > len(self.files):
            self._epoch += 1
            self._pos = 0
            self._perm = self._epoch_perm(self._epoch)
        state = (self._epoch, self._pos)
        idx = self._perm[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return state, [self.files[i] for i in idx]

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._native_decode is None:
            # deferred auto-probe (see constructor): resolve once, here
            from glom_tpu_torch import native

            self._native_decode = native.has_jpeg()
            if self._native_decode:
                self._native_pool = self._make_native_pool()
        while len(self._pending) < self._prefetch:
            state, paths = self._advance()
            if self._native_decode:
                # one future per batch on the single-slot native pool: the
                # C++ core runs its own (worker-capped) threads per call
                from glom_tpu_torch import native

                fut = self._native_pool.submit(
                    native.decode_jpeg_batch, paths, self.image_size,
                    self._workers,
                )
                get = fut.result
            else:
                # per-file futures (not a nested batch task): a batch-level
                # task blocking on decodes in the same pool could deadlock it
                futs = [
                    self._pool.submit(_decode, p, self.image_size, self.channels)
                    for p in paths
                ]

                def get(futs=futs):
                    return np.stack([f.result() for f in futs])

            self._pending.append((state, get))
        _, get = self._pending.popleft()
        return get()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Deterministic shutdown of the decode pools (idempotent): drops
        read-ahead work and joins the Python pool and the native-dispatch
        slot — the ``Prefetcher.close()`` contract, so a wrapped stream
        tears down end to end instead of leaking executors."""
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)
        pool = getattr(self, "_native_pool", None)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "ImageFolderStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
