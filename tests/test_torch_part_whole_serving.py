"""The port's part-whole endpoints (/parse, /similar, /session/parse through
glom_tpu_torch/serving/engine.py and server.py) against glom_tpu's engine on
the CPU, on one checkpoint of the small config (dim 32, 3 levels, 16/4).

The thresholds sit in the middle of the widest gap between the agreement
values of each level's middle 60 % (glom_tpu's maps), so that the two
forwards' float32 differences (about 1e-7) cannot move a cell across one: the labels,
counts and sizes are then bitwise glom_tpu's, the means within 1e-5.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.hierarchy.index import write_index_parts as jax_write_index_parts
from glom_tpu.models.islands import neighbor_agreement
from glom_tpu.serving.engine import ServingEngine as JaxServingEngine
from glom_tpu.serving.engine import make_demo_checkpoint as jax_make_demo_checkpoint
from glom_tpu_torch.hierarchy.parse import island_deltas, parse_row_width, unpack_parse
from glom_tpu_torch.serving.engine import ServingEngine
from glom_tpu_torch.serving.server import make_server

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
SIDE, N, L, D = 4, 16, 3, 32
MEAN_ATOL = 1e-5
SCORE_ATOL = 1e-5
# the agreement a threshold keeps from every cell, at least: twenty times the
# two forwards' difference in agreement
MARGIN = 2e-6


def _imgs(k, seed=0):
    return np.random.default_rng(seed).standard_normal((k, 3, 16, 16)).astype(np.float32)


def _split(rows):
    """Packed rows -> (labels, counts, sizes, means)."""
    return (rows[:, :L * N], rows[:, L * N:L * N + L], rows[:, L * N + L:2 * L * N + L],
            rows[:, 2 * L * N + L:])


def _gap_thresholds(states):
    """Per level, the midpoint of the widest gap among the agreement values
    between the 20 % and 80 % quantiles of glom_tpu's maps."""
    agree = np.asarray(neighbor_agreement(jnp.asarray(states), SIDE))
    thr = []
    for lv in range(L):
        vals = np.sort(agree[:, lv].ravel())
        lo, hi = int(0.2 * len(vals)), int(0.8 * len(vals))
        i = lo + int(np.argmax(np.diff(vals[lo:hi + 1])))
        thr.append(float((vals[i] + vals[i + 1]) / 2))
        assert np.abs(vals - thr[-1]).min() > MARGIN
    return tuple(thr)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("part_whole_ckpt"))
    jax_make_demo_checkpoint(d, config=jax_config.GlomConfig(**TINY))
    return d


@pytest.fixture(scope="module")
def corpus():
    return _imgs(6, seed=9)


@pytest.fixture(scope="module")
def pair(ckpt, corpus, tmp_path_factory):
    """Both engines with the same gap thresholds, sessions, and one index of
    the corpus written by glom_tpu's write_index_parts from glom_tpu's index
    forward."""
    probe = JaxServingEngine(ckpt, buckets=(2,), warmup=False, reload_poll_s=0,
                             quality_sample=0)
    states = np.concatenate([np.asarray(probe.caches["index"](probe.params, corpus[i:i + 2]))
                             for i in range(0, 6, 2)])
    thr = _gap_thresholds(np.concatenate(
        [states, np.asarray(probe.caches["index"](probe.params, _imgs(2, seed=4)))]))
    index = str(tmp_path_factory.mktemp("index"))
    jax_write_index_parts(index, 0, 6, states)
    kw = dict(buckets=(1, 2), reload_poll_s=0, warm_iters=2, parse_thresholds=thr,
              index_dir=index)
    ours = ServingEngine(ckpt, device="cpu", **kw)
    theirs = JaxServingEngine(ckpt, warmup=False, quality_sample=0, **kw)
    yield ours, theirs
    ours.shutdown(drain=False)
    theirs.shutdown(drain=False)


def test_index_forward_agrees_with_glom_tpus(pair):
    ours, theirs = pair
    x = _imgs(2, seed=3)
    got = ours.run("index", x)
    want = np.asarray(theirs.caches["index"](theirs.params, x))
    assert got.dtype == np.float32 and got.shape == (2, N, L, D)
    assert np.abs(got - want).max() <= 1e-6


def test_parse_rows_are_glom_tpus(pair):
    ours, theirs = pair
    x = _imgs(2, seed=4)
    fut = ours.submit("parse", x)
    assert ours.process_once("parse") == 2
    got = fut.result(timeout=30)
    want = np.asarray(theirs.caches["parse"](theirs.params, x))
    assert got.shape == want.shape == (2, parse_row_width(L, SIDE, D))
    for g, w in zip(_split(got)[:3], _split(want)[:3]):
        assert np.array_equal(g, w)
    assert np.abs(_split(got)[3] - _split(want)[3]).max() <= MEAN_ATOL
    counts = _split(got)[1]
    assert counts.min() >= 1, "the thresholds leave a level without an island"


def test_parse_replay_equals_its_eager_path(pair):
    ours, _ = pair
    x = _imgs(1, seed=5)
    assert np.array_equal(ours.run("parse", x), ours.run_eager("parse", x))


def test_the_pack_on_glom_tpus_state_is_glom_tpus(pair):
    """The post-pass alone, fed glom_tpu's own index state: the rows are its
    apply_post's (labels, counts, sizes bitwise; means 1e-5)."""
    ours, theirs = pair
    state = np.array(theirs.caches["index"](theirs.params, _imgs(2, seed=6)))
    got = ours.caches["parse"].apply_post(torch.from_numpy(state))
    want = np.asarray(theirs.caches["parse"].apply_post(jnp.asarray(state)))
    for g, w in zip(_split(got)[:3], _split(want)[:3]):
        assert np.array_equal(g, w)
    assert np.abs(_split(got)[3] - _split(want)[3]).max() <= MEAN_ATOL


@pytest.mark.parametrize("level", [None, 0, 1])
def test_similar_is_glom_tpus(pair, corpus, level):
    """Every slot ranked (k = the corpus): the same slots in the same order,
    scores within 1e-5.  Two slots may trade places only where their own
    scores tie within that tolerance (this random model's whole-image
    vectors, at the top level, agree to 1e-6)."""
    ours, theirs = pair
    probe = np.concatenate([corpus[3:4], _imgs(1, seed=8)])
    got, info = ours.similar(probe, level=level, k=6)
    want, their_info = theirs.similar(probe, level=level, k=6)
    assert info == their_info
    for g, w in zip(got, want):
        assert max(abs(a["score"] - b["score"]) for a, b in zip(g, w)) <= SCORE_ATOL
        score = {r["slot"]: r["score"] for r in g}
        assert sorted(score) == list(range(6))
        for a, b in zip(g, w):
            assert a["slot"] == b["slot"] or abs(score[a["slot"]] - score[b["slot"]]) <= SCORE_ATOL
    assert {r["slot"]: r["score"] for r in got[0]}[3] == pytest.approx(1.0, abs=1e-4)
    if level is not None:   # search by part: the image is its own top hit
        assert [g[0]["slot"] for g in (got[0], want[0])] == [3, 3]


def test_session_parse_deltas_are_glom_tpus(pair):
    ours, theirs = pair
    frames = [_imgs(1, seed=40), _imgs(1, seed=40), _imgs(1, seed=41)]
    prev = None
    for t, x in enumerate(frames):
        got, info = ours.session_parse("parse-cam", x)
        want, their_info = theirs.session_parse("parse-cam", x)
        assert info == their_info, t
        assert info["cold"] == (t == 0)
        labels = np.rint(got[:, :L * N]).reshape(1, L, SIDE, SIDE).astype(np.int32)
        assert info["deltas"] == [island_deltas(prev, labels[0])]
        prev = labels[0]
    # an embed frame and a parse frame share the session's one state
    _, info = ours.session_embed("parse-cam", frames[0])
    assert info["frames"] == 4 and not info["cold"]


def test_health_reports_the_new_fields_as_glom_tpu_does(pair):
    ours, theirs = pair
    got, want = ours.health(), theirs.health()
    for key in ("quant", "tenants"):
        assert got[key] == want[key]
    assert set(got["sessions"]) == set(want["sessions"])
    assert got["hierarchy"]["parse_thresholds"] == want["hierarchy"]["parse_thresholds"]
    assert got["hierarchy"]["index"] == want["hierarchy"]["index"]
    assert ours.registry.snapshot().get("serving_graph_captures", 0) == 0


def test_engine_arguments_of_the_part_whole_endpoints(ckpt):
    """The threshold grammar's errors reach the caller, and the SLOs may
    name the session and similarity paths, as in glom_tpu."""
    with pytest.raises(ValueError, match="3 levels"):
        ServingEngine(ckpt, device="cpu", warmup=False, parse_thresholds="0.9,0.8")
    eng = ServingEngine(ckpt, device="cpu", warmup=False, parse_thresholds=0.5,
                        slos=["session:p95<250ms", "similar:p95<250ms", "parse:p95<900ms"])
    assert eng.health()["hierarchy"]["parse_thresholds"] == [0.5, 0.5, 0.5]
    with pytest.raises(ValueError, match="unknown endpoint"):
        ServingEngine(ckpt, device="cpu", warmup=False, slos=["index:p95<900ms"])


def test_similar_is_refused_without_an_index(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0, warmup=False)
    assert not eng.similar_enabled and eng.health()["hierarchy"]["index"] is None
    with pytest.raises(RuntimeError, match="index disabled"):
        eng.similar(_imgs(1))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_routes_over_http(pair, corpus):
    ours, _ = pair
    ours.start()
    srv = make_server(ours, port=0)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    url = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        parse = _post(url + "/parse", {"images": _imgs(2, seed=4).tolist()})
        similar = _post(url + "/similar", {"images": corpus[2].tolist(), "level": 0, "k": 2})
        bad_k = _post(url + "/similar", {"images": corpus[2].tolist(), "k": 0})
        sess = _post(url + "/session/parse", {"session": "http-cam",
                                              "images": _imgs(1, seed=7).tolist()})
    finally:
        srv.shutdown()
        srv.server_close()
    assert parse[0] == 200 and len(parse[1]["islands"]) == 2
    want = unpack_parse(ours.run("parse", _imgs(2, seed=4))[0], L, SIDE, D)
    assert [isl["labels"] for isl in parse[1]["islands"][0]] == [isl["labels"] for isl in want]
    assert similar[0] == 200 and similar[1]["results"][0][0]["slot"] == 2
    assert similar[1]["level"] == 0 and len(similar[1]["results"][0]) == 2
    assert bad_k[0] == 400
    assert sess[0] == 200 and sess[1]["cold"] and len(sess[1]["deltas"]) == 1
    assert len(sess[1]["islands"][0]) == L
