"""The port's graph cache (``glom_tpu_torch/serving/compile_cache.py``).

On the CPU: ``pick_bucket`` and ``pad_to_bucket`` against
``glom_tpu.serving.compile_cache`` on ``tests/test_serving.py``'s cases, the
request path's padding (padded rows give the unpadded answers bit for bit),
the lazy-bucket count behind ``serving_graph_captures``, the device lock, a
stateful cache's contract and ``PostPassCache``'s.

Tests marked ``gpu`` hold every bucket's replayed graph against the same
engine's eager forward bit for bit (also at int8, for the session families
and for ``/parse``, and ``/parse`` at buckets captured on the request path), the launch counts under replay, a hot reload under
replaying workers, reloads and shadow -> rollback cycles that keep allocated
memory, a promote (local or router-pinned) that captures nothing, a
capture that outlives a graph freed on another thread, and a capture that
must fail (in a process of its own); without a card they skip.  This file imports JAX only inside the parity tests, so on
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
    PostPassCache,
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
    # buckets 1 and 4 of embed, and of the quality post-pass that samples
    # every batch by default (glom_tpu counts its lazy compiles alike)
    assert engine.registry.snapshot()["serving_graph_captures"] == 4.0
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


def test_device_lock_lets_waiting_replays_in_between_two_captures():
    """A replay that waits through one capture runs before the next, even
    when the capturing thread asks again at once (a candidate's set is
    captured one bucket a hold so that live traffic gets through)."""
    from tests.polling import poll_until

    lock = DeviceLock()
    order = []
    holding = threading.Event()

    def captures():
        with lock.exclusive():
            holding.set()
            assert poll_until(lambda: lock._shared_waiting == 1)
            order.append("capture 1")
        with lock.exclusive():
            order.append("capture 2")

    def replay():
        assert holding.wait(5)
        with lock.shared():
            order.append("replay")

    threads = [threading.Thread(target=captures), threading.Thread(target=replay)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert order == ["capture 1", "replay", "capture 2"]


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


@pytest.mark.parametrize("path", ["embed", "session_warm", "parse", "apply_post"])
def test_a_lazy_capture_comes_before_any_hold_on_the_device_lock(path):
    """On the card a capture takes the device lock alone, so a thread that
    held it shared while it captured would wait on itself for good (and,
    counted as waiting, stop every other replay).  Every request path
    prepares its graphs before it takes its hold: each capture here sees no
    shared holder."""
    lock = DeviceLock()
    inner = BucketedGraphCache(lambda p, x: x * p["w"], (2, 4), input_shape=(2,),
                               device="cpu", name="toy", lock=lock)
    post = PostPassCache(inner, lambda y: y.sum(dim=-1, keepdim=True), state_shape=(2,))
    warm = BucketedGraphCache(lambda p, x, s: (x.sum(dim=-1) + s[:, 0], s + 1), (2, 4),
                              input_shape=(2,), device="cpu", name="warm", lock=lock,
                              carries_state=True, takes_state=True, state_shape=(1,),
                              state_dtype=torch.float32)
    holders = []
    for family in (inner, post, warm):
        def probe(key, capture=family._capture, name=family.name):
            holders.append((name, lock._shared))
            return capture(key)

        family._capture = probe
    params, x = {"w": torch.tensor(2.0)}, np.ones((3, 2), np.float32)
    run = {"embed": lambda: inner(params, x),
           "session_warm": lambda: warm(params, x, state=torch.zeros(4, 1)),
           "parse": lambda: post(params, x),
           "apply_post": lambda: post.apply_post(torch.ones(4, 2), 3)}[path]
    run()
    want = {"embed": ["toy"], "session_warm": ["warm"], "parse": ["parse", "toy"],
            "apply_post": ["parse"]}[path]
    assert holders == [(name, 0) for name in want]


def _stateful(takes_state=True):
    """A cache over ``(x.sum(-1) + state.sum(-1), state + x.sum(-1))``."""
    def fn(params, x, state=None):
        s = x.sum(dim=-1, keepdim=True)
        state = torch.zeros_like(s) if state is None else state
        return s[:, 0] + state[:, 0] * params["w"], state + s

    return BucketedGraphCache(fn, (2, 4), input_shape=(3,), device="cpu", name="s",
                              carries_state=True, takes_state=takes_state,
                              state_shape=(1,) if takes_state else None,
                              state_dtype=torch.float32 if takes_state else None)


def test_a_stateful_cache_takes_a_bucket_state_and_hands_back_its_own():
    params = {"w": torch.tensor(2.0)}
    cold, warm = _stateful(takes_state=False), _stateful()
    x = np.arange(9, dtype=np.float32).reshape(3, 3)
    out, state = cold(params, x)
    assert out.tolist() == [3.0, 12.0, 21.0] and tuple(state.shape) == (4, 1)
    out2, state2 = warm(params, x, state=state)
    assert out2.tolist() == [9.0, 36.0, 63.0] and state2 is not state
    assert state2[:3, 0].tolist() == [6.0, 24.0, 42.0] and state[:3, 0].tolist() == [3.0, 12.0, 21.0]
    with pytest.raises(ValueError, match="carried state of shape"):
        warm(params, x)
    with pytest.raises(ValueError, match="carried state of shape"):
        warm(params, x, state=state[:2])
    with pytest.raises(ValueError, match="takes_state requires carries_state"):
        BucketedGraphCache(lambda p, x, s: x, (1,), input_shape=(1,), device="cpu",
                           takes_state=True)
    with pytest.raises(ValueError, match="state_shape and state_dtype"):
        BucketedGraphCache(lambda p, x, s: x, (1,), input_shape=(1,), device="cpu",
                           carries_state=True, takes_state=True)


def test_post_pass_cache_runs_the_post_pass_on_the_inner_forward():
    inner = _toy(buckets=(2, 4))
    post = PostPassCache(inner, lambda y: y.sum(dim=-1, keepdim=True) * 10, state_shape=(2,))
    params = {"w": torch.tensor(3.0)}
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert post(params, x).tolist() == [[30.0], [150.0], [270.0]]
    assert np.array_equal(post.eager(params, x), post(params, x))
    # a bucket not prepared at start-up counts a capture, the inner's too
    assert post.poll_captures() == 2 and post.poll_captures() == 0
    post.warmup(params)
    assert post.warmed and post.poll_captures() == 0
    rows = post.apply_post(torch.ones(4, 2, dtype=torch.float64), 3)
    assert rows.tolist() == [[20.0]] * 3 and post.poll_captures() == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# a small model the kernels run without padding (d a multiple of 128)
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
def test_a_graph_freed_on_another_thread_leaves_a_capture_valid(cuda):
    """A retired set's graphs are freed where their last reference drops, on
    any thread (a rollback, a reload's commit); such a free while another
    graph is captured must not invalidate that capture."""
    from glom_tpu_torch.serving.compile_cache import _capture_graph

    x = torch.arange(4.0, device=cuda)
    held = [_capture_graph(lambda t: t * 2, (x,), cuda, None)[0]]
    freed = threading.Event()

    def drop():
        held.clear()                    # the last reference: the graph is destroyed
        freed.set()

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            threading.Thread(target=drop).start()
            assert freed.wait(30)
        return t + 1

    graph, out, _ = _capture_graph(fn, (x,), cuda, None)
    assert not held
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x + 1)


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


@pytest.mark.gpu
def test_shadow_rollback_cycles_keep_allocated_memory(cuda, card_ckpt):
    """A rollback retires the candidate's set, its graphs, pools and
    parameters with it: three shadow -> rollback cycles leave allocated
    memory within 1 % of where it stood before the first."""
    import gc

    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0, warm_iters="auto")
    make_demo_checkpoint(card_ckpt, config=CARD, seed=9, step=1)
    gc.collect()
    torch.cuda.synchronize(cuda)
    before = torch.cuda.memory_allocated(cuda)
    for _ in range(3):
        assert engine.deploy.begin_shadow(step=1) == 1
        assert torch.cuda.memory_allocated(cuda) > before
        assert engine.deploy.rollback()["action"] == "rolled_back"
    gc.collect()
    torch.cuda.synchronize(cuda)
    after = torch.cuda.memory_allocated(cuda)
    engine.shutdown(drain=False)
    assert abs(after - before) <= 0.01 * before, (before, after)


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [False, True])
def test_a_promote_captures_nothing(cuda, card_ckpt, pinned):
    """Both kinds of promote capture nothing: the local swap, and the one
    pinned through a router, whose /admin/reload/prepare + commit stage the
    resident candidate set.  The candidate's graphs then serve, bitwise its
    eager forward."""
    from glom_tpu_torch.serving.compile_cache import captures_made

    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0)
    make_demo_checkpoint(card_ckpt, config=CARD, seed=11, step=1)
    assert engine.deploy.begin_canary(fraction=0.5, step=1) == 1
    cand = engine.deploy.candidate(1)
    if pinned:
        def router(url, body, timeout):       # the router's two-phase rollout, in process
            assert engine.stage_reload(step=1) == 1
            assert engine.commit_staged() == 1
            return 200, b'{"status": "committed"}'

        engine.deploy.pin_url, engine.deploy._http = "http://router", router
    made = captures_made()
    report = engine.deploy.promote()
    assert captures_made() == made and report["fleet_pin"]["ok"]
    assert engine.step == 1 and engine.serving is cand.caches
    x = np.random.default_rng(12).standard_normal((2, 3, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(engine.run("embed", x), engine.run_eager("embed", x))
    assert engine.registry.snapshot().get("serving_graph_captures", 0) == 0
    engine.shutdown(drain=False)


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


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_quantized_replays_bitwise_the_eager_forward(cuda, card_ckpt, quant):
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0, quant=quant, buckets=(1, 4))
    x = np.random.default_rng(4).standard_normal((3, 3, 16, 16)).astype(np.float32)
    for endpoint in ("embed", "reconstruct", "index"):
        np.testing.assert_array_equal(engine.run(endpoint, x), engine.run_eager(endpoint, x))
    assert engine.registry.snapshot().get("serving_graph_captures") is None


@pytest.mark.gpu
def test_session_families_replay_bitwise_and_hand_back_owned_state(cuda, card_ckpt):
    """A warm replay equals the eager warm forward on the same state, and the
    state it hands back is a copy: another replay of the bucket leaves it as
    it was."""
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0, warm_iters=2, buckets=(2,))
    rng = np.random.default_rng(5)
    x, y = (rng.standard_normal((2, 3, 16, 16)).astype(np.float32) for _ in range(2))
    out, state = engine.run("session_cold", x)
    eager_out, eager_state = engine.run_eager("session_cold", x)
    np.testing.assert_array_equal(out, eager_out)
    assert torch.equal(state, eager_state)
    kept = state.clone()
    warm, new = engine.run("session_warm", x, state=state)
    engine.run("session_warm", y, state=new)          # another replay of the bucket
    assert torch.equal(state, kept)
    want, want_state = engine.run_eager("session_warm", x, state=kept)
    np.testing.assert_array_equal(warm, want)
    assert torch.equal(new, want_state)


@pytest.mark.gpu
def test_parse_replays_its_eager_path(cuda, card_ckpt):
    """/parse replayed against the eager index forward and pack: labels,
    counts and sizes bitwise, the means within 1e-5 (the pack's atomic
    sums)."""
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0, parse_thresholds=0.5)
    c = CARD
    n, L = c.num_patches, c.levels
    rng = np.random.default_rng(6)
    for b in (1, 3, 8):
        x = rng.standard_normal((b, 3, 16, 16)).astype(np.float32)
        got, want = engine.run("parse", x), engine.run_eager("parse", x)
        cut = 2 * L * n + L
        np.testing.assert_array_equal(got[:, :cut], want[:, :cut])
        assert np.abs(got[:, cut:] - want[:, cut:]).max() <= 1e-5


@pytest.mark.gpu
def test_parse_captures_its_graphs_on_the_request_path(cuda, card_ckpt):
    """An engine built without warm-up (the server's ``--no-warmup``)
    captures /parse's index and pack graphs at a bucket's first request, and
    /session/parse's cold forward and pack at a session's first frame, and
    the quality post-pass the parse batch is sampled for (the default
    quality_sample=1.0): no capture waits on its own thread's hold on the
    device lock, and each is counted in serving_graph_captures."""
    engine = ServingEngine(card_ckpt, device=cuda, ff_impl="pallas", attention_impl="pallas",
                           reload_poll_s=0, parse_thresholds=0.5, warm_iters=2,
                           buckets=(1, 4), warmup=False, max_wait_ms=0.0)
    x = np.random.default_rng(7).standard_normal((3, 3, 16, 16)).astype(np.float32)
    served = {}

    def serve():
        fut = engine.submit("parse", x)
        engine.process_once("parse")
        served["parse"] = fut.result(timeout=60)
        served["session"] = engine.session_parse("lazy", x[:1])[0]

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    worker.join(120)
    assert not worker.is_alive(), "a capture on the request path waited on its own hold"
    assert engine.registry.snapshot()["serving_graph_captures"] == 5.0
    n, L = CARD.num_patches, CARD.levels
    cut = 2 * L * n + L
    want = engine.run_eager("parse", x)
    np.testing.assert_array_equal(served["parse"][:, :cut], want[:, :cut])
    assert np.abs(served["parse"][:, cut:] - want[:, cut:]).max() <= 1e-5
    assert served["session"].shape == (1, want.shape[1])
    engine.shutdown(drain=False)
