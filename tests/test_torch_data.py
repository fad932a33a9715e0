"""The port's data streams and native batcher against ``glom_tpu``'s, and the
state that crosses between the two packages.

Every stream is held bitwise against ``glom_tpu``'s on the same seed: the
``folder`` stream (native and NumPy paths; uint8 NHWC and float32 NCHW;
``.npz``; a memory-mapped ``.npy``), the augmentations, the image-folder
stream (PNG and JPEG written with PIL; its two-integer cursor) and
``make_batches``.  Then the checkpoints: a port checkpoint with an image
stream's cursor restores in ``glom_tpu``'s ``Trainer`` and gives the same next
batch, and the other way round; the shims' params-only checkpoints cross
too.  Every test closes the streams it opens.
"""

import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu import native as jax_native
from glom_tpu.training import data as jax_data
from glom_tpu.training import image_stream as jax_stream
from glom_tpu_torch import Glom, native
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.training import data, image_stream
from glom_tpu_torch.training.trainer import Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)


def _draw(it, n):
    return [next(it) for _ in range(n)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """36 images in 3 class folders: PNG and JPEG, of several sizes, with a
    per-class color and noise, written with PIL."""
    from PIL import Image

    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for c in range(3):
        sub = root / f"class_{c}"
        sub.mkdir()
        for i in range(12):
            arr = np.clip(rng.normal(60 + 60 * c, 30, (18 + i % 3, 20, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(sub / (f"img_{i:02d}.jpg" if i % 2 else f"img_{i:02d}.png"))
    return str(root)


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """20 JPEGs in 2 class folders (the native decode path takes all-JPEG trees)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(1)
    for c in range(2):
        sub = root / f"c{c}"
        sub.mkdir()
        for i in range(10):
            arr = rng.integers(0, 255, (24, 20 + i, 3), dtype=np.uint8)
            Image.fromarray(arr).save(sub / f"{i}.jpg", quality=90)
    return str(root)


def test_batcher_source_is_glom_tpu_s_and_builds_into_the_port():
    """``batcher.cpp`` is ``glom_tpu``'s as it is; the loader builds it into
    the port's own ignored ``build/`` directory and exposes its entry points."""
    with open(os.path.join(REPO, "glom_tpu", "native", "batcher.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "glom_tpu_torch", "native", "batcher.cpp"), "rb") as f:
        assert f.read() == want
    lib = native.load()
    assert lib is not None and lib is native.load()
    assert os.path.dirname(lib._name) == os.path.join(REPO, "glom_tpu_torch", "native", "build")
    assert native.has_jpeg() == jax_native.has_jpeg()


@pytest.mark.parametrize("dtype,layout", [("uint8", "nhwc"), ("float32", "nchw")])
def test_assemble_batch_matches_glom_tpu_and_numpy(dtype, layout):
    rng = np.random.default_rng(2)
    shape = (10, 20, 24, 3) if layout == "nhwc" else (10, 3, 20, 24)
    arr = (rng.integers(0, 255, shape).astype(np.uint8) if dtype == "uint8"
           else rng.standard_normal(shape).astype(np.float32))
    idx = rng.integers(0, 10, 6)
    got = native.assemble_batch(arr, idx, 16)
    np.testing.assert_array_equal(got, jax_native.assemble_batch(arr, idx, 16))
    x = arr[idx].transpose(0, 3, 1, 2) if layout == "nhwc" else arr[idx]
    x = x.astype(np.float32) / 127.5 - 1.0 if dtype == "uint8" else x
    np.testing.assert_array_equal(got, data._resize_nchw(x, 16))
    with pytest.raises(IndexError):
        native.assemble_batch(arr, np.array([10]), 16)
    assert native.assemble_batch(arr.astype(np.int16), idx, 16) is None


def _write_dataset(directory, kind):
    rng = np.random.default_rng(3)
    if kind == "u8_nhwc_npy":
        np.save(os.path.join(directory, "x.npy"), rng.integers(0, 255, (30, 20, 20, 3), np.uint8))
    elif kind == "f32_nchw_npy":
        np.save(os.path.join(directory, "x.npy"), rng.standard_normal((30, 3, 12, 20), np.float32))
    elif kind == "npz_two_files":
        np.savez(os.path.join(directory, "a.npz"), x=rng.integers(0, 255, (12, 18, 18, 3), np.uint8),
                 labels=np.arange(12))
        np.save(os.path.join(directory, "b.npy"), rng.integers(0, 255, (9, 18, 18, 3), np.uint8))
    else:   # float NHWC: neither native layout
        np.save(os.path.join(directory, "x.npy"), rng.random((30, 16, 16, 3), np.float32))


@pytest.mark.parametrize("kind", ["u8_nhwc_npy", "f32_nchw_npy", "npz_two_files", "f32_nhwc_npy"])
def test_folder_batches_match_glom_tpu(tmp_path, kind):
    """Bitwise the batches of ``glom_tpu``'s ``folder_batches``, on the
    native path and on the NumPy path (which agree), memory-mapped for a
    single ``.npy``."""
    _write_dataset(str(tmp_path), kind)
    for use_native in (True, False):
        got = _draw(data.folder_batches(str(tmp_path), 5, 16, seed=4, use_native=use_native), 3)
        want = _draw(jax_data.folder_batches(str(tmp_path), 5, 16, seed=4,
                                             use_native=use_native), 3)
        _assert_same(got, want)
    _assert_same(_draw(data.folder_batches(str(tmp_path), 5, 16, seed=4, use_native=False), 3),
                 _draw(data.folder_batches(str(tmp_path), 5, 16, seed=4), 3))


def test_folder_batches_fall_back_to_numpy_with_the_same_stream(tmp_path, monkeypatch):
    """Without the native core the NumPy path gives the same bits: the probe
    comes before any draw of the generator."""
    _write_dataset(str(tmp_path), "u8_nhwc_npy")
    want = _draw(data.folder_batches(str(tmp_path), 4, 16, seed=5), 2)
    monkeypatch.setattr(native, "load", lambda: None)
    _assert_same(_draw(data.folder_batches(str(tmp_path), 4, 16, seed=5), 2), want)


def test_folder_batches_refuse_bad_datasets(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(data.folder_batches(str(tmp_path), 2, 16))
    np.save(tmp_path / "x.npy", np.zeros((4, 8, 8, 1), np.uint8))
    with pytest.raises(ValueError, match="channels"):
        next(data.folder_batches(str(tmp_path), 2, 16))
    np.save(tmp_path / "x.npy", np.zeros((4, 8, 8), np.uint8))
    with pytest.raises(ValueError, match="4-D"):
        next(data.folder_batches(str(tmp_path), 2, 16))


@pytest.mark.parametrize("kind", data.AUGMENT_KINDS)
def test_augmentations_match_glom_tpu(kind):
    assert data.AUGMENT_KINDS == jax_data.AUGMENT_KINDS
    batch = np.random.default_rng(6).standard_normal((6, 3, 16, 16)).astype(np.float32)
    got = data.augment_batch(batch, np.random.default_rng(7), kind)
    want = jax_data.augment_batch(batch, np.random.default_rng(7), kind)
    np.testing.assert_array_equal(got, want)
    src = [batch, batch[::-1].copy()]
    _assert_same(list(data.augmented(iter(src), kind, seed=3)),
                 list(jax_data.augmented(iter(src), kind, seed=3)))
    with pytest.raises(ValueError, match="unknown augmentation"):
        data.augmented(iter(src), "rotate")


@pytest.mark.parametrize("native_decode", [None, False])
def test_image_stream_matches_glom_tpu(image_tree, jpeg_tree, native_decode):
    """Bitwise the batches and cursors of ``glom_tpu``'s ``ImageFolderStream``
    over two epochs, sharded and not (a mixed PNG/JPEG tree decodes with PIL;
    an all-JPEG tree with the native core under ``native_decode=None``)."""
    for root in (image_tree, jpeg_tree):
        for shard in ((0, 1), (1, 2)):
            kw = dict(seed=3, process_index=shard[0], process_count=shard[1], workers=2,
                      prefetch=2, native_decode=native_decode)
            with image_stream.ImageFolderStream(root, 4, 16, **kw) as got, \
                    jax_stream.ImageFolderStream(root, 4, 16, **kw) as want:
                assert got.files == want.files
                for _ in range(7):
                    np.testing.assert_array_equal(next(got), next(want))
                    assert got.state_dict() == want.state_dict()


def test_image_stream_resumes_on_the_exact_next_batch(image_tree):
    with image_stream.ImageFolderStream(image_tree, 5, 16, seed=1, workers=2) as a:
        _draw(a, 3)
        cursor = a.state_dict()
        want = _draw(a, 5)
    with image_stream.ImageFolderStream(image_tree, 5, 16, seed=1, workers=2) as b:
        b.load_state_dict(cursor)
        _assert_same(_draw(b, 5), want)


def test_image_helpers_match_glom_tpu(image_tree):
    files = image_stream.list_image_files(image_tree)
    assert files == jax_stream.list_image_files(image_tree)
    assert image_stream.IMAGE_EXTENSIONS == jax_stream.IMAGE_EXTENSIONS
    labels, names = image_stream.labels_from_paths(files)
    want_labels, want_names = jax_stream.labels_from_paths(files)
    np.testing.assert_array_equal(labels, want_labels)
    assert names == want_names == ["class_0", "class_1", "class_2"]
    np.testing.assert_array_equal(image_stream.load_images(files[:6], 16, workers=2),
                                  jax_stream.load_images(files[:6], 16, workers=2))
    with pytest.raises(ValueError, match="3 channels"):
        image_stream.load_images(files[:1], 16, channels=1)


def test_decode_without_a_decoder_names_the_three(image_tree, monkeypatch):
    """Where neither cv2 nor PIL imports, a JPEG decodes in the native core;
    without libjpeg too, the error names the three decoders and no file is
    skipped."""
    jpg = [f for f in image_stream.list_image_files(image_tree) if f.endswith(".jpg")][0]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = image_stream._decode(jpg, 16, 3)
    np.testing.assert_array_equal(got, native.decode_jpeg_batch([jpg], 16, 1)[0])
    monkeypatch.setattr(native, "has_jpeg", lambda: False)
    with pytest.raises(RuntimeError, match="cv2 and PIL do not import.*libjpeg"):
        image_stream._decode(jpg, 16, 3)


@pytest.mark.parametrize("kind,augment", [("synthetic", "none"), ("folder", "flip"),
                                          ("images", "none"), ("images", "flip_crop")])
def test_make_batches_matches_glom_tpu(tmp_path, image_tree, kind, augment):
    directory = None
    if kind == "folder":
        directory = str(tmp_path)
        _write_dataset(directory, "u8_nhwc_npy")
    elif kind == "images":
        directory = image_tree
    got = data.make_batches(kind, 4, 16, 3, 2, directory, augment=augment)
    want = jax_data.make_batches(kind, 4, 16, 3, 2, directory, augment=augment)
    try:
        _assert_same(_draw(got, 4), _draw(want, 4))
        assert hasattr(got, "state_dict") == hasattr(want, "state_dict") == (kind == "images")
        if kind == "images":
            assert got.state_dict() == want.state_dict()
    finally:
        got.close()
        want.close()


def test_make_batches_refuses_what_the_port_lacks():
    with pytest.raises(NotImplementedError, match="'elastic'.*ROADMAP queue 1, item 6"):
        data.make_batches("elastic", 4, 16)
    with pytest.raises(ValueError, match="unknown data source"):
        data.make_batches("webdataset", 4, 16)
    for kind in ("folder", "images"):
        with pytest.raises(ValueError, match="needs data_dir"):
            data.make_batches(kind, 4, 16)


def test_prefetcher_delivers_in_order_and_reraises():
    items = [np.full((1,), i, np.float32) for i in range(5)]
    with data.Prefetcher(iter(items), depth=2) as p:
        _assert_same(list(p), items)
        with pytest.raises(StopIteration):
            next(p)

    def failing():
        yield items[0]
        raise KeyError("decoder died")

    with data.Prefetcher(failing(), depth=2) as p:
        next(p)
        with pytest.raises(KeyError, match="decoder died"):
            next(p)


def test_prefetcher_close_stops_a_blocked_worker_and_surfaces_its_error():
    """``close`` joins a worker parked on a full queue (within glom_tpu's
    close timeout) and re-raises a failure the consumer never drew."""
    def endless():
        while True:
            yield np.zeros(1, np.float32)

    p = data.Prefetcher(endless(), depth=1)
    time.sleep(0.05)
    p.close()
    assert not p._thread.is_alive()
    with pytest.raises(StopIteration):
        next(p)

    def dies():
        raise OSError("disk gone")
        yield

    q = data.Prefetcher(dies(), depth=1)
    q._thread.join(timeout=5.0)
    assert not q._thread.is_alive()
    with pytest.raises(OSError, match="disk gone"):
        q.close()


def test_stateful_prefetcher_reports_the_consumer_cursor(image_tree):
    """With batches in flight, the cursor is the consumer's, and a rewind
    re-seeds the stream: the batches after it are the ones after that
    cursor."""
    base = threading.active_count()
    with pytest.raises(TypeError, match="resumable"):
        data.StatefulPrefetcher(iter([]))
    inner = image_stream.ImageFolderStream(image_tree, 4, 16, seed=2, workers=2, prefetch=1)
    with data.StatefulPrefetcher(inner, depth=3) as p:
        _draw(p, 2)
        time.sleep(0.2)   # let the worker read ahead
        cursor = p.state_dict()
        want = _draw(p, 3)
        p.load_state_dict(cursor)
        assert p.state_dict() == cursor
        _assert_same(_draw(p, 3), want)
        aug = data._StatefulAugmented(p, "flip", 0)
        assert aug.state_dict() == p.state_dict()
    with image_stream.ImageFolderStream(image_tree, 4, 16, seed=2, workers=2) as plain:
        _draw(plain, 2)
        assert plain.state_dict() == cursor
    deadline = time.monotonic() + 5.0
    while threading.active_count() > base and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= base


# -- state that crosses between the packages ---------------------------------

# glom_tpu's trainer runs over the tests' 8 faked CPU devices: a batch of 8
B = 8

def _port_trainer(directory, steps, **kw):
    train = TrainConfig(batch_size=B, steps=steps, log_every=0, seed=0,
                        checkpoint_dir=directory, checkpoint_every=steps, **kw)
    return Trainer(GlomConfig(**TINY), train, device="cpu")


def _jax_trainer(directory, steps, **kw):
    from glom_tpu.training.trainer import Trainer as JaxTrainer

    train = jax_config.TrainConfig(batch_size=B, steps=steps, log_every=0, seed=0,
                                   checkpoint_dir=directory, checkpoint_every=steps, **kw)
    return JaxTrainer(jax_config.GlomConfig(**TINY), train)


@pytest.mark.parametrize("opt", [dict(), dict(weight_decay=0.05, grad_clip_norm=1.0,
                                              lr_schedule="cosine", warmup_steps=1)],
                         ids=["adam", "clip_adamw_cosine"])
def test_port_checkpoint_resumes_in_glom_tpu_on_the_next_batch(tmp_path, image_tree, opt):
    """The port's ``fit`` on an image stream saves its cursor; ``glom_tpu``'s
    ``Trainer.restore(batches=)`` takes the checkpoint (params, the optax
    layout of its chain, a PRNG key) and its stream goes on with the batch
    the port's would have drawn next."""
    d = str(tmp_path / "ck")
    with data.make_batches("images", B, 16, seed=1, data_dir=image_tree) as stream:
        trainer = _port_trainer(d, 3, **opt)
        trainer.fit(stream)
        cursor = stream.state_dict()
        want = next(stream)
    with jax_data.make_batches("images", B, 16, seed=1, data_dir=image_tree) as jstream:
        jt = _jax_trainer(None, 3, **opt)
        assert jt.restore(d, batches=jstream) == 3
        assert jstream.state_dict() == cursor
        np.testing.assert_array_equal(next(jstream), want)
    got = jax.tree_util.tree_leaves(jt.state.params)
    mine = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), trainer.state.params))
    for g, w in zip(got, mine):
        np.testing.assert_array_equal(np.asarray(g), w)
    adam = jt.state.opt_state[1][0] if opt else jt.state.opt_state[0]
    assert int(adam.count) == trainer.state.opt_state["count"] == 3


def test_glom_tpu_checkpoint_resumes_in_the_port_on_the_next_batch(tmp_path, image_tree):
    """The reverse: ``glom_tpu``'s ``fit`` on its image stream, restored by
    the port's ``Trainer.restore(batches=)``, which warns that the JAX key
    does not carry over."""
    d = str(tmp_path / "ck")
    jstream = jax_data.make_batches("images", B, 16, seed=1, data_dir=image_tree,
                                    augment="flip")
    try:
        _jax_trainer(d, 2).fit(jstream)
        cursor = jstream.state_dict()
    finally:
        jstream.close()
    with jax_stream.ImageFolderStream(image_tree, B, 16, seed=1, process_index=0,
                                      process_count=1) as ref:
        ref.load_state_dict(cursor)
        want = next(ref)
    with data.make_batches("images", B, 16, seed=1, data_dir=image_tree) as stream:
        trainer = _port_trainer(None, 2)
        with pytest.warns(UserWarning, match="noise generator starts fresh"):
            assert trainer.restore(d, batches=stream) == 2
        assert stream.state_dict() == cursor
        np.testing.assert_array_equal(next(stream), want)


def test_port_resume_without_data_state_warns(tmp_path, image_tree):
    d = str(tmp_path / "ck")
    _port_trainer(d, 1).fit(iter([np.zeros((B, 3, 16, 16), np.float32)]))
    with data.make_batches("images", B, 16, data_dir=image_tree) as stream:
        with pytest.warns(UserWarning, match="no data-iterator state"):
            _port_trainer(None, 1).restore(d, batches=stream)
        assert stream.state_dict() == {"epoch": 0, "pos": 0}


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v.detach() if torch.is_tensor(v) else v)


def test_fit_resumes_the_stream_and_the_run_bitwise(tmp_path, image_tree):
    """Two steps, a checkpoint with the cursor, then a new trainer and a new
    stream: ``fit`` restores both and takes the next two steps as an
    unbroken run of four does."""
    with data.make_batches("images", B, 16, seed=1, data_dir=image_tree) as s:
        whole = _port_trainer(None, 4)
        whole.fit(s)
    d = str(tmp_path / "ck")
    for steps in (2, 4):
        with data.make_batches("images", B, 16, seed=1, data_dir=image_tree) as s:
            part = _port_trainer(d, steps)
            part.fit(s)
    want = dict(_items(whole.state.params))
    for k, v in _items(part.state.params):
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_shim_checkpoints_cross_both_ways(tmp_path):
    """``Glom.save`` of either package loads in the other's ``Glom.load``:
    the same parameters, the same forward."""
    from glom_tpu import Glom as JaxGlom

    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    port = Glom(**TINY, device="cpu", generator=torch.Generator().manual_seed(3))
    port.save(a, step=5)
    ref = JaxGlom(**TINY)
    assert ref.load(a) == 5
    want = dict(_items(port.params()))
    for k, v in _items(ref.params):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    img = np.random.default_rng(4).standard_normal((2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        mine = port(torch.from_numpy(img), iters=2).numpy()
    np.testing.assert_allclose(np.asarray(ref(img, iters=2)), mine, atol=1e-5)

    JaxGlom(**TINY, rng=jax.random.PRNGKey(9)).save(b, step=7)
    ref.load(b)
    other = Glom(**TINY, device="cpu")
    assert other.load(b) == 7 and other.load(b, step=7) == 7
    want = dict(_items(ref.params))
    for k, v in _items(other.params()):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    with pytest.raises(ValueError, match="shapes"):
        Glom(dim=64, levels=3, image_size=16, patch_size=4, device="cpu").load(b)
    with pytest.raises(FileNotFoundError):
        other.load(str(tmp_path / "empty"))
