"""The port's serving path (glom_tpu_torch.serving, checkpoint, denoise)
against glom_tpu on the CPU.

A checkpoint written by glom_tpu's own ``make_demo_checkpoint`` is served by
the port's engine with ``device="cpu"`` over real HTTP on a free port, and
the answers are held against glom_tpu's ``apply`` + mean (``/embed``) and
``decoder_apply`` at the loss timestep (``/reconstruct``).  Float32; 1e-4
absolute over a forward of 2*L iterations, as in test_torch_model.py.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.models import glom as jax_glom
from glom_tpu.models import heads as jax_heads
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu.serving.engine import make_demo_checkpoint as jax_make_demo_checkpoint
from glom_tpu.training import denoise as jax_denoise
from glom_tpu_torch import checkpoint as ckpt_lib
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.models import glom as glom_model
from glom_tpu_torch.models.heads import decoder_apply
from glom_tpu_torch.serving.batcher import Closed, DynamicBatcher, Overloaded
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.training import denoise

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

FWD_ATOL = 1e-4
TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imgs(k, seed=0, size=16):
    return np.random.default_rng(seed).standard_normal((k, 3, size, size)).astype(np.float32)


def _request(url, payload=None, raw=None):
    """``(status, json body)`` of a GET (no payload) or POST."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Served:
    """An engine behind the port's HTTP server on a free port."""

    def __init__(self, engine, *, workers=True):
        self.engine = engine
        engine.start(workers=workers)
        self.server = make_server(engine, port=0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       kwargs={"poll_interval": 0.05}, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.engine.shutdown(drain=False)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint written by glom_tpu: a decoder with a hidden layer and
    the loss read at timestep 4 of the default 6 iterations."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jax_make_demo_checkpoint(
        d, config=jax_config.GlomConfig(**TINY),
        train=jax_config.TrainConfig(batch_size=2, steps=0, decoder="mlp", loss_level=1),
        seed=3)
    return d


@pytest.fixture(scope="module")
def served(jax_ckpt):
    s = _Served(ServingEngine(jax_ckpt, device="cpu", max_wait_ms=1.0, ff_impl="pallas",
                              attention_impl="pallas"))
    yield s
    s.close()


def _jax_reference(directory, imgs):
    """glom_tpu's embeddings and reconstruction of ``imgs``."""
    _, cfg, train, params = jax_denoise.load_checkpoint_state(directory)
    x = jnp.asarray(imgs)
    embed = jnp.mean(jax_glom.apply(params["glom"], x, config=cfg), axis=1)
    iters = train.iters if train.iters is not None else cfg.default_iters
    t = jax_denoise.resolve_loss_timestep(train, iters)
    _, captured = jax_glom.apply(params["glom"], x, config=cfg, iters=iters, capture_timestep=t)
    recon = jax_heads.decoder_apply(params["decoder"], captured, cfg, arch=train.decoder,
                                    level=train.loss_level)
    return np.asarray(embed), np.asarray(recon)


def test_http_answers_match_glom_tpu(served, jax_ckpt):
    imgs = _imgs(3)
    want_embed, want_recon = _jax_reference(jax_ckpt, imgs)

    code, body = _request(served.url + "/embed", {"images": imgs.tolist()})
    assert code == 200 and body["step"] == 0 and body["latency_ms"] > 0
    got = np.asarray(body["embeddings"], np.float32)
    assert got.shape == (3, 3, 32)
    np.testing.assert_allclose(got, want_embed, atol=FWD_ATOL)

    for level in (1, -1):
        code, body = _request(served.url + "/embed", {"images": imgs.tolist(), "level": level})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["embeddings"], np.float32),
                                   want_embed[:, level], atol=FWD_ATOL)

    code, body = _request(served.url + "/reconstruct", {"images": imgs[:2].tolist()})
    assert code == 200 and body["step"] == 0
    got = np.asarray(body["images"], np.float32)
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got, want_recon[:2], atol=FWD_ATOL)

    # one (c, H, W) image is a batch of one
    code, body = _request(served.url + "/embed", {"images": imgs[0].tolist()})
    assert code == 200
    np.testing.assert_allclose(np.asarray(body["embeddings"], np.float32), want_embed[:1],
                               atol=FWD_ATOL)


def test_healthz_reports_the_contract_and_the_kernels(served):
    code, health = _request(served.url + "/healthz")
    assert code == 200 and health["status"] == "ok"
    # the engine's explicit kernel selection overrides the checkpoint's recorded "dense"
    assert health["ff_impl"] == "pallas" and health["attention_impl"] == "pallas"
    assert health["buckets"] == [1, 2, 4, 8] and health["step"] == 0
    assert (health["image_size"], health["channels"], health["levels"], health["dim"]) == (16, 3, 3, 32)
    assert health["device"] == "cpu"
    assert set(health["kernel_launches"]) == {"grouped_ff", "consensus_attention",
                                              "fused_level_update"}


def test_engine_serves_the_checkpoints_kernel_choice_as_glom_tpu(tmp_path):
    """A bfloat16 ``ff_impl="fused"`` checkpoint written by glom_tpu is served
    with the checkpoint's kernel choice by default, as glom_tpu's engine
    serves it: the fused step, ``/healthz`` naming ``fused`` and the
    recorded ``attention_impl``.  Its ``/embed`` answer is held against
    glom_tpu's engine on the same images within one bfloat16 rounding of the
    largest value, 2**-8 max|want|.  Forcing ``"pallas"`` (what the engine
    did before it kept the checkpoint's choice) rounds at other places than
    glom_tpu's fused path: 9.8e-4 max-abs (cosine 0.9999932) at this size,
    above that bound; the fused path is 6.1e-5 off."""
    d = str(tmp_path)
    jax_make_demo_checkpoint(d, config=jax_config.GlomConfig(
        **TINY, compute_dtype=jnp.bfloat16, ff_impl="fused"), seed=3)
    imgs = _imgs(3)
    ref = JaxServingEngine(d, buckets=(1, 2, 4), max_wait_ms=0.0, warmup=False, reload_poll_s=0)
    try:
        fut = ref.submit("embed", imgs)
        assert ref.process_once("embed") == 3
        want = np.asarray(fut.result(timeout=60), np.float32)
    finally:
        ref.shutdown(drain=False)
    assert (ref.config.ff_impl, ref.config.attention_impl) == ("fused", "dense")
    bound = 2.0 ** -8 * np.abs(want).max()

    s = _Served(ServingEngine(d, device="cpu", max_wait_ms=1.0))
    try:
        code, health = _request(s.url + "/healthz")
        assert code == 200
        assert (health["ff_impl"], health["attention_impl"]) == ("fused", "dense")
        assert s.engine._fused_fn is not None
        assert s.engine.config.resolved_compute_dtype == torch.bfloat16
        code, body = _request(s.url + "/embed", {"images": imgs.tolist()})
        assert code == 200
        got = np.asarray(body["embeddings"], np.float32)
    finally:
        s.close()
    assert got.shape == want.shape == (3, 3, 32)
    gap = np.abs(got - want).max()
    assert gap <= bound, (gap, bound)

    # an explicit choice still overrides the checkpoint's
    forced = ServingEngine(d, device="cpu", ff_impl="pallas", attention_impl="pallas")
    assert forced._fused_fn is None
    assert (forced.health()["ff_impl"], forced.health()["attention_impl"]) == ("pallas", "pallas")
    assert gap <= np.abs(forced.run("embed", imgs) - want).max()


@pytest.mark.parametrize("endpoint", ["embed", "reconstruct"])
def test_bucket_padding_gives_the_unpadded_rows(served, endpoint):
    engine = served.engine
    imgs = _imgs(3, seed=5)
    padded = engine.run(endpoint, imgs)             # bucket 4: one zero image appended
    assert padded.shape[0] == 3
    x = torch.from_numpy(imgs)
    with torch.inference_mode():
        if endpoint == "embed":
            want = glom_model.apply(engine.params["glom"], x, config=engine.config).mean(dim=1)
        else:
            state = glom_model.apply(engine.params["glom"], x, config=engine.config,
                                     iters=engine.reconstruct_timestep)
            want = decoder_apply(engine.params["decoder"], state, engine.config,
                                 arch=engine.train_cfg.decoder,
                                 level=engine.train_cfg.loss_level)
    np.testing.assert_allclose(padded, want.numpy(), atol=1e-6)


@pytest.mark.parametrize("payload,what", [
    ({"images": np.zeros((1, 3, 8, 8)).tolist()}, "images must be"),
    ({"images": np.zeros((2, 16, 16)).tolist()}, "images must be"),
    ({"pictures": []}, "bad 'images'"),
    ({"images": np.zeros((1, 3, 16, 16)).tolist(), "level": 3}, "level"),
    ({"images": np.zeros((9, 3, 16, 16)).tolist()}, "max_batch"),
    (b"{not json", "invalid JSON"),
])
def test_bad_requests_are_400(served, payload, what):
    raw = payload if isinstance(payload, bytes) else None
    code, body = _request(served.url + "/embed", None if raw else payload, raw=raw)
    assert code == 400 and what in body["error"]


def test_shed_request_is_503(jax_ckpt):
    engine = ServingEngine(jax_ckpt, device="cpu", buckets=(1, 2), max_queue=2)
    s = _Served(engine, workers=False)      # nothing drains the queue
    try:
        pending = engine.submit("embed", _imgs(2))
        code, body = _request(s.url + "/embed", {"images": _imgs(1).tolist()})
        assert code == 503 and body["error"] == "overloaded"
        assert engine.process_once("embed") == 2 and pending.result(timeout=30).shape == (2, 3, 32)
    finally:
        s.close()


def test_unknown_route_is_404(served):
    assert _request(served.url + "/parse", {"images": []})[0] == 404
    assert _request(served.url + "/nothing")[0] == 404


def _tiny_port_ckpt(directory, decoder="linear"):
    make_demo_checkpoint(directory, config=GlomConfig(**TINY),
                         train=TrainConfig(batch_size=2, steps=0, decoder=decoder), seed=7)


@pytest.mark.parametrize("damage", ["bitflip", "rewritten"])
def test_corrupt_npz_raises_crc_error(tmp_path, damage):
    """A corrupt newest step: pinned, it raises the CRC error; by default the
    loader (and the engine) quarantine it and fall back to the newest valid
    step, as glom_tpu does; with no valid step left nothing loads."""
    d = str(tmp_path)
    _tiny_port_ckpt(d)
    ckpt_lib.save(d, 1, {"params": ckpt_lib.load_tree(d, 0, "params")})
    path = ckpt_lib.npz_path(d, 1)
    if damage == "bitflip":
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
    else:
        # a well-formed npz whose arrays no longer match the sidecar's CRCs
        arrays = ckpt_lib.load_arrays(d, 0)
        arrays["params/glom/pos_emb"] = arrays["params/glom/pos_emb"] + 1.0
        np.savez(path, **arrays)
    with pytest.raises(ckpt_lib.CorruptCheckpointError):
        denoise.load_checkpoint_state(d, step=1, device="cpu")
    with pytest.warns(UserWarning, match="quarantined corrupt checkpoint step 1"):
        engine = ServingEngine(d, device="cpu")
    assert engine.step == 0 and os.path.exists(path + ".corrupt")
    assert ckpt_lib.latest_step(d) == 1     # the manifest still names the bad step
    os.replace(ckpt_lib.npz_path(d, 0), ckpt_lib.npz_path(d, 0) + ".gone")
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        ServingEngine(d, device="cpu")


def test_checkpoint_without_config_match_is_refused(tmp_path):
    d = str(tmp_path)
    _tiny_port_ckpt(d)
    with open(os.path.join(d, "config.json")) as f:
        payload = json.load(f)
    payload["glom"]["dim"] = 64
    ckpt_lib.write_json(d, "config.json", payload)
    with pytest.raises(ValueError, match="does not match"):
        denoise.load_checkpoint_state(d, device="cpu")


@pytest.mark.parametrize("decoder", ["linear", "mlp_all"])
def test_port_checkpoint_restores_in_glom_tpu(tmp_path, decoder):
    d = str(tmp_path)
    _tiny_port_ckpt(d, decoder)
    step, cfg, train, params = jax_denoise.load_checkpoint_state(d)
    assert step == 0 and cfg.dim == 32 and train.decoder == decoder
    _, _, _, ours = denoise.load_checkpoint_state(d, device="cpu")
    flat_jax = ckpt_lib.flatten({"params": params})
    flat_ours = ckpt_lib.flatten({"params": glom_model.tree_map(lambda t: t.numpy(), ours)})
    assert set(flat_jax) == set(flat_ours)
    for k in flat_jax:
        np.testing.assert_array_equal(np.asarray(flat_jax[k]), flat_ours[k], err_msg=k)


def test_loss_timestep_resolution_matches_glom_tpu():
    for iters in (1, 6, 12):
        for t in (None, 0, iters):
            ours = denoise.resolve_loss_timestep(TrainConfig(loss_timestep=t), iters)
            theirs = jax_denoise.resolve_loss_timestep(jax_config.TrainConfig(loss_timestep=t), iters)
            assert ours == theirs
    with pytest.raises(ValueError):
        denoise.resolve_loss_timestep(TrainConfig(loss_timestep=7), 6)


def test_cli_serves_a_demo_checkpoint_and_drains(tmp_path):
    """``python -m glom_tpu_torch.serving.server --demo --device cpu``: one
    request over HTTP, then SIGTERM drains and exits 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "glom_tpu_torch.serving.server", "--checkpoint-dir",
         str(tmp_path / "ckpt"), "--demo", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        events = []
        for line in proc.stdout:
            events.append(json.loads(line))
            if events[-1]["event"] == "serving":
                break
        assert [e["event"] for e in events] == ["demo_checkpoint", "serving"], proc.stderr.read()
        info = events[-1]
        url = "http://127.0.0.1:%d" % info["port"]
        img = np.zeros((1, info["channels"], info["image_size"], info["image_size"]))
        code, body = _request(url + "/embed", {"images": img.tolist()})
        assert code == 200
        assert np.asarray(body["embeddings"]).shape == (1, info["levels"], info["dim"])
        proc.terminate()
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert json.loads(out.strip().splitlines()[-1])["event"] == "drained"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_batcher_flush_rules_with_a_fake_clock():
    clock = _FakeClock()
    b = DynamicBatcher(max_batch=4, max_wait_ms=10.0, max_queue=5, clock=clock)
    f1 = b.submit("a", size=1)
    b.submit("b", size=2)
    assert b.next_batch(block=False) is None          # 3 < 4 and no deadline yet
    clock.t = 0.011
    batch = b.next_batch(block=False)                 # the oldest item's deadline
    assert [i.payload for i in batch] == ["a", "b"] and b.depth == 0
    b.submit("c", size=3)
    b.submit("d", size=2)                             # 5 queued >= 4: full
    assert [i.payload for i in b.next_batch(block=False)] == ["c"]  # "d" would overflow
    with pytest.raises(Overloaded):
        b.submit("e", size=4)                         # 2 queued + 4 > 5: shed
    with pytest.raises(ValueError, match="max_batch"):
        b.submit("f", size=5)                         # could never flush
    b.close(drain=True)
    assert [i.payload for i in b.next_batch(block=False)] == ["d"]
    assert b.next_batch(block=True) is None           # closed and dry: the worker exits
    with pytest.raises(Closed):
        b.submit("g")
    assert not f1.done()                              # the worker, not the batcher, resolves


def test_batcher_close_without_drain_fails_the_queued():
    b = DynamicBatcher(max_batch=2, max_wait_ms=1000.0, max_queue=4, clock=_FakeClock())
    fut = b.submit("a")
    b.close(drain=False)
    with pytest.raises(Closed):
        fut.result(timeout=1)
    assert b.depth == 0 and b.closed
