"""The port's graph cache (``glom_tpu_torch/serving/compile_cache.py``).

On the CPU: ``pick_bucket`` and ``pad_to_bucket`` against
``glom_tpu.serving.compile_cache`` on ``tests/test_serving.py``'s cases, the
request path's padding (padded rows give the unpadded answers bit for bit),
the lazy-bucket count behind ``serving_graph_captures``, and the device lock.

Tests marked ``gpu`` hold every bucket's replayed graph against the same
engine's eager forward bit for bit, the launch counts under replay, a hot
reload under replaying workers, reloads that keep allocated memory, and a
capture that must fail (in a process of its own); without a card they
skip.  This file imports JAX only inside the parity tests, so on
the GPU machine (which has no JAX)

    python -m pytest --noconftest -q -m gpu tests/test_torch_compile_cache.py
"""

import threading

import numpy as np
import pytest
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.kernels import _common, wrappers
from glom_tpu_torch.serving.compile_cache import (
    BucketedGraphCache,
    DeviceLock,
    pad_to_bucket,
    pick_bucket,
)
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)


def _toy(buckets=(2, 4), device="cpu"):
    """A cache over ``x * w`` on (b, 2) inputs."""
    return BucketedGraphCache(lambda params, x: x * params["w"], buckets, input_shape=(2,),
                              device=device, name="toy")


@pytest.mark.parametrize("buckets,n", [((1, 2, 4), 1), ((1, 2, 4), 3), ((1, 2, 4), 4),
                                       ((1, 2, 4), 5), ((2, 4, 8), 1), ((1, 2, 4, 8), 8),
                                       ((1, 2, 4, 8), 9)])
def test_pick_bucket_matches_glom_tpu(buckets, n):
    from glom_tpu.serving import compile_cache as jax_cc

    assert pick_bucket(buckets, n) == jax_cc.pick_bucket(buckets, n)


def test_pick_bucket_refuses_an_empty_batch_as_glom_tpu():
    from glom_tpu.serving import compile_cache as jax_cc

    for pick in (pick_bucket, jax_cc.pick_bucket):
        with pytest.raises(ValueError):
            pick((1, 2), 0)


@pytest.mark.parametrize("b,bucket", [(3, 4), (3, 3), (1, 8), (5, 8)])
def test_pad_to_bucket_matches_glom_tpu(b, bucket):
    from glom_tpu.serving import compile_cache as jax_cc

    x = np.arange(b * 2, dtype=np.float32).reshape(b, 2) + 1
    ours, theirs = pad_to_bucket(x, bucket), jax_cc.pad_to_bucket(x, bucket)
    assert ours.shape == theirs.shape == (bucket, 2) and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    assert not ours[b:].any()
    if b == bucket:
        assert ours is x and theirs is x
    for pad in (pad_to_bucket, jax_cc.pad_to_bucket):
        with pytest.raises(ValueError, match="exceeds"):
            pad(x, b - 1 if b > 1 else 0)


def test_request_path_pads_slices_and_counts_no_capture_after_warmup():
    cache = _toy()
    params = {"w": torch.tensor(3.0)}
    cache.warmup(params)
    assert cache.warmed and cache.warmup_seconds is not None
    for n in (1, 2, 3, 4):
        x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        out = cache(params, x)
        assert out.shape == (n, 2)
        np.testing.assert_array_equal(out, x * 3.0)
    assert cache.poll_captures() == 0
    with pytest.raises(ValueError, match="largest bucket"):
        cache(params, np.ones((5, 2), np.float32))


def test_a_lazy_bucket_counts_one_capture():
    cache = _toy()
    params = {"w": torch.tensor(2.0)}
    assert not cache.warmed
    cache(params, np.ones((1, 2), np.float32))      # bucket 2, first use
    cache(params, np.ones((2, 2), np.float32))      # bucket 2 again
    assert cache.poll_captures() == 1
    cache(params, np.ones((3, 2), np.float32))      # bucket 4
    assert cache.poll_captures() == 1 and cache.poll_captures() == 0


def _engine(directory, **kw):
    return ServingEngine(directory, device="cpu", ff_impl="pallas", attention_impl="pallas",
                         max_wait_ms=0.0, reload_poll_s=0, **kw)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    make_demo_checkpoint(d, config=TINY, seed=4)
    return d


@pytest.mark.parametrize("endpoint", ["embed", "reconstruct"])
def test_padded_rows_give_the_unpadded_answers_bitwise(tiny_ckpt, endpoint):
    """Each image served in a padded bucket equals the same image served at
    its own bucket, bit for bit: the padding rows never reach a real one."""
    engine = _engine(tiny_ckpt, buckets=(1, 4, 8))
    imgs = np.random.default_rng(6).standard_normal((3, 3, 16, 16)).astype(np.float32)
    padded = engine.run(endpoint, imgs)                   # bucket 4
    assert padded.shape[0] == 3
    for i in range(3):
        alone = engine.run(endpoint, imgs[i:i + 1])        # bucket 1
        np.testing.assert_array_equal(padded[i:i + 1], alone)
    np.testing.assert_array_equal(engine.run_eager(endpoint, imgs), padded)


def test_engine_counts_lazy_captures_into_the_registry(tiny_ckpt):
    engine = _engine(tiny_ckpt, buckets=(1, 2, 4), warmup=False)
    assert not engine.health()["warm"]
    for k in (1, 3, 1, 4):
        fut = engine.submit("embed", np.zeros((k, 3, 16, 16), np.float32))
        assert engine.process_once("embed") == k
        fut.result(timeout=30)
    assert engine.registry.snapshot()["serving_graph_captures"] == 2.0   # buckets 1 and 4
    warmed = _engine(tiny_ckpt, buckets=(1, 2, 4))
    assert warmed.health()["warm"]
    for k in (1, 3, 2):
        warmed.submit("reconstruct", np.zeros((k, 3, 16, 16), np.float32))
        warmed.process_once("reconstruct")
    snap = warmed.registry.snapshot()
    assert "serving_graph_captures" not in snap and "serving_warmup_seconds" in snap


def test_device_lock_lets_a_waiting_capture_in_before_new_replays():
    lock = DeviceLock()
    order = []
    replay_in = threading.Event()
    release = threading.Event()

    def replay(name, hold):
        with lock.shared():
            order.append(name)
            if hold:
                replay_in.set()
                release.wait(5)

    def capture():
        with lock.exclusive():
            order.append("capture")

    first = threading.Thread(target=replay, args=("r1", True))
    first.start()
    assert replay_in.wait(5)
    cap = threading.Thread(target=capture)
    cap.start()
    # the capture is waiting: a new replay must queue behind it
    from tests.polling import poll_until

    assert poll_until(lambda: lock._waiting == 1)
    late = threading.Thread(target=replay, args=("r2", False))
    late.start()
    release.set()
    for t in (first, cap, late):
        t.join(5)
    assert order == ["r1", "capture", "r2"]


def test_launch_recording_counts_replays_not_the_capture():
    fn = wrappers()["grouped_ff"]
    before = fn.launches
    with _common.recording_launches() as recorded:
        _common.count(fn)
        _common.count(fn)
    assert fn.launches == before and recorded == {fn: 2}
    _common.add_replayed(recorded)
    _common.add_replayed(recorded)
    assert fn.launches == before + 4
    fn.launches = before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# the smallest model the kernels take (d a multiple of 128)
CARD = GlomConfig(dim=128, levels=3, image_size=16, patch_size=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs of the kernels capture only on the GPU")
    return torch.device("cuda")


@pytest.fixture
def card_ckpt(tmp_path):
    make_demo_checkpoint(str(tmp_path), config=CARD, seed=2)
    return str(tmp_path)


@pytest.mark.gpu
@pytest.mark.parametrize("ff_impl", ["pallas", "fused"])
def test_every_bucket_replays_bitwise_the_eager_forward(cuda, card_ckpt, ff_impl):
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl=ff_impl, attention_impl="pallas",
                           reload_poll_s=0)
    rng = np.random.default_rng(3)
    for endpoint in ("embed", "reconstruct"):
        assert sorted(engine.caches[endpoint]._graphs) == [1, 2, 4, 8]
        for b in (1, 2, 3, 4, 5, 8):
            x = rng.standard_normal((b, 3, 16, 16)).astype(np.float32)
            np.testing.assert_array_equal(engine.run(endpoint, x), engine.run_eager(endpoint, x))
    assert engine.registry.snapshot().get("serving_graph_captures") is None


@pytest.mark.gpu
@pytest.mark.parametrize("ff_impl", ["pallas", "fused"])
def test_replays_count_the_launches_of_the_eager_forward(cuda, card_ckpt, ff_impl):
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl=ff_impl, attention_impl="pallas",
                           reload_poll_s=0)
    x = np.zeros((3, 3, 16, 16), np.float32)
    counted = {}
    for path in ("eager", "replay"):
        for fn in wrappers().values():
            fn.launches = 0
        (engine.run_eager if path == "eager" else engine.run)("embed", x)
        counted[path] = {k: fn.launches for k, fn in wrappers().items()}
    assert counted["replay"] == counted["eager"]
    iters = engine.embed_iters
    want = ({"fused_level_update": iters} if ff_impl == "fused"
            else {"grouped_ff": 2 * iters, "consensus_attention": iters})
    assert {k: v for k, v in counted["replay"].items() if v} == want


@pytest.mark.gpu
def test_hot_reload_under_replaying_workers(cuda, card_ckpt):
    """Workers replay while the watcher's reload captures the new set: no
    request fails, and after the swap the answers are the new weights'."""
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0, max_wait_ms=1.0)
    engine.start(workers=True, watch=False)
    x = np.random.default_rng(9).standard_normal((2, 3, 16, 16)).astype(np.float32)
    before = engine.run("embed", x)
    errors, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            try:
                engine.submit("embed", x).result(timeout=60)
            except Exception as e:  # every failure is the test's to report
                errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        make_demo_checkpoint(card_ckpt, config=CARD, seed=5, step=1)
        assert engine.check_reload() is True and engine.step == 1
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        engine.shutdown(drain=True)
    assert not errors, errors[:3]
    after = engine.run("embed", x)
    np.testing.assert_array_equal(after, engine.run_eager("embed", x))
    assert not np.array_equal(after, before)


@pytest.mark.gpu
def test_reloads_keep_allocated_memory(cuda, card_ckpt):
    """Every reload captures a new set and frees the old one: a second
    reload leaves allocated memory where the first left it."""
    import gc

    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0)
    allocated = []
    for step in (1, 2, 3):
        make_demo_checkpoint(card_ckpt, config=CARD, seed=5 + step, step=step)
        assert engine.check_reload() is True and engine.step == step
        gc.collect()
        torch.cuda.synchronize(cuda)
        allocated.append(torch.cuda.memory_allocated(cuda))
    assert allocated[2] == allocated[1], allocated


# a forward the card cannot capture: a host read inside
_FAILING_CAPTURE = """
import numpy as np, torch
from glom_tpu_torch.serving.compile_cache import BucketedGraphCache
dev = torch.device("cuda")
cache = BucketedGraphCache(lambda params, x: x * float((x * params["w"]).sum().item()),
                           (2,), input_shape=(2,), device=dev, name="sync")
params = {"w": torch.ones((), device=dev)}
for what, call in (("warmup", lambda: cache.warmup(params)),
                   ("request", lambda: cache(params, np.ones((1, 2), np.float32)))):
    try:
        call()
    except RuntimeError:
        print(what, "raised")
    else:
        print(what, "served")
"""


@pytest.mark.gpu
def test_a_capture_that_fails_raises(cuda):
    """A forward the card cannot capture raises, at warm-up and on the
    request path; the cache never serves it eagerly instead.  It runs in a
    process of its own: a refused capture may leave that process's CUDA
    context unusable, and no other test may share it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE], capture_output=True,
                          text=True, timeout=300, cwd=repo, env=env)
    assert proc.stdout.split("\n")[:2] == ["warmup raised", "request raised"], (
        proc.returncode, proc.stdout, proc.stderr[-2000:])
