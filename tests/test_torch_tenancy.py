"""The port's tenant bulkheads (glom_tpu_torch/serving/batcher.py's
TokenBucket, parse_quota and TenantAdmission, the engine's tenant admission
and the server's X-Tenant) against glom_tpu's on the CPU, under one fake
clock."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from glom_tpu.serving import batcher as jax_batcher
from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.serving import batcher
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_token_bucket_matches_glom_tpus():
    clock = FakeClock()
    ours = batcher.TokenBucket(2.0, 3.0, clock=clock)
    theirs = jax_batcher.TokenBucket(2.0, 3.0, clock=clock)
    trace = []
    for dt, n in [(0, 1), (0, 2), (0, 1), (0.25, 1), (0.5, 1), (0.1, 0.5), (10, 3), (0, 1)]:
        clock.t += dt
        trace.append((ours.take(n), theirs.take(n), ours.tokens, theirs.tokens))
    assert all(a == b and x == y for a, b, x, y in trace)
    assert [t[0] for t in trace] == [True, True, False, False, True, True, True, False]


@pytest.mark.parametrize("rate,burst", [(0.0, 1.0), (1.0, 0.5), (-1.0, 2.0)])
def test_token_bucket_refuses_what_glom_tpus_refuses(rate, burst):
    with pytest.raises(ValueError) as ours:
        batcher.TokenBucket(rate, burst)
    with pytest.raises(ValueError) as theirs:
        jax_batcher.TokenBucket(rate, burst)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", ["5", "5:10", "0.5", "2.5:1", (2, 3), [1, 4]])
def test_parse_quota_grammar_is_glom_tpus(spec):
    assert batcher.parse_quota(spec) == jax_batcher.parse_quota(spec)


def test_admission_admit_refund_snapshot_match_glom_tpus():
    clock = FakeClock()
    quotas = {"a": "2:3", "b": "1"}
    ours = batcher.TenantAdmission(quotas, clock=clock)
    theirs = jax_batcher.TenantAdmission(quotas, clock=clock)

    def both(fn):
        out = []
        for adm, exc in ((ours, batcher.TenantQuotaExceeded),
                         (theirs, jax_batcher.TenantQuotaExceeded)):
            try:
                fn(adm)
                out.append("ok")
            except exc as e:
                out.append(("shed", e.tenant, str(e)))
        assert out[0] == out[1]
        assert ours.snapshot() == theirs.snapshot()
        return out[0]

    steps = [lambda a: a.admit("a", 2), lambda a: a.admit("a", 2), lambda a: a.admit("b", 1),
             lambda a: a.admit("b", 1), lambda a: a.refund("a", 2), lambda a: a.admit("a", 3),
             lambda a: a.admit(None, 100), lambda a: a.admit("unknown", 100),
             lambda a: a.refund("unknown", 1)]
    outcomes = [both(step) for step in steps[:4]]
    clock.t += 0.4
    outcomes += [both(step) for step in steps[4:]]
    assert [o if o == "ok" else o[0] for o in outcomes] == [
        "ok", "shed", "ok", "shed", "ok", "ok", "ok", "ok", "ok"]
    snap = ours.snapshot()
    assert set(snap) == {"a", "b"} and snap["a"]["shed_requests"] == 1
    assert snap["a"]["admitted_images"] == 3


def test_quota_shed_is_an_overloaded():
    assert issubclass(batcher.TenantQuotaExceeded, batcher.Overloaded)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tenant_ckpt"))
    make_demo_checkpoint(d, config=GlomConfig(**TINY))
    return d


def _imgs(k):
    return np.random.default_rng(0).standard_normal((k, 3, 16, 16)).astype(np.float32)


def test_engine_sheds_the_tenant_and_refunds_a_global_shed(ckpt):
    clock = FakeClock()
    eng = ServingEngine(ckpt, device="cpu", buckets=(1, 2), reload_poll_s=0, max_queue=2,
                        clock=clock, tenant_quotas={"a": "1:2", "b": (1, 4)})
    eng.submit("embed", _imgs(2), tenant="a")
    with pytest.raises(batcher.TenantQuotaExceeded) as e:
        eng.submit("embed", _imgs(1), tenant="a")
    assert e.value.tenant == "a"
    # tenant b is admitted by its own bucket, then the full queue sheds it:
    # its tokens come back
    with pytest.raises(batcher.Overloaded) as e:
        eng.submit("embed", _imgs(2), tenant="b")
    assert not isinstance(e.value, batcher.TenantQuotaExceeded)
    tenants = eng.health()["tenants"]
    assert tenants["b"]["tokens"] == 4.0 and tenants["b"]["admitted_images"] == 0
    assert tenants["a"]["shed_requests"] == 1
    snap = eng.registry.snapshot()
    assert snap["serving_tenant_shed_a"] == 1.0 and snap["serving_shed_total"] == 2.0
    assert eng.process_once("embed") == 2


def _post(url, payload, headers):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_x_tenant_over_http(ckpt):
    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0,
                        tenant_quotas={"a": "0.01:2"}, warm_iters=2)
    eng.start()
    srv = make_server(eng, port=0)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % srv.server_address[1]
    try:
        body = {"images": _imgs(1).tolist()}
        codes = [_post(url + "/embed", body, {"X-Tenant": "a"})[0] for _ in range(2)]
        shed = _post(url + "/parse", body, {"X-Tenant": "a"})
        other = _post(url + "/embed", body, {"X-Tenant": "other"})
        session = _post(url + "/session/embed", {"session": "s", **body}, {"X-Tenant": "a"})
        empty = _post(url + "/embed", body, {"X-Tenant": ""})
        bad = _post(url + "/session/embed", {"session": "s", **body}, {"X-Tenant": "a b"})
        # a handler reports its outcome just after its reply: wait for the
        # last tenant request's
        deadline = time.monotonic() + 10
        while (eng.registry.snapshot().get("serving_tenant_requests_a") != 4.0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        snap = eng.registry.snapshot()
    finally:
        srv.shutdown()
        srv.server_close()
        eng.shutdown(drain=False)
    want = {"error": "tenant_overloaded", "tenant": "a",
            "detail": "tenant admission quota exhausted; back off"}
    assert codes == [200, 200] and shed == (503, want) and session == (503, want)
    assert other[0] == 200
    assert empty[0] == 400 and "bad X-Tenant ''" in empty[1]["error"]
    assert bad[0] == 400 and "bad X-Tenant" in bad[1]["error"]
    assert snap["serving_tenant_requests_a"] == 4.0 and snap["serving_tenant_errors_a"] == 2.0
    assert snap["serving_tenant_shed_a"] == 2.0 and "serving_tenant_shed_other" not in snap


def test_a_bad_tenant_leaves_a_keep_alive_connection_usable(ckpt):
    """The 400 for a bad X-Tenant consumes the request's body, so the next
    request on the same connection is read from its own start."""
    import http.client

    eng = ServingEngine(ckpt, device="cpu", buckets=(1,), reload_poll_s=0)
    eng.start()
    srv = make_server(eng, port=0)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
    body = json.dumps({"images": _imgs(1).tolist()})
    try:
        replies = []
        for tenant in ("bad tenant", "good"):
            conn.request("POST", "/embed", body=body,
                         headers={"Content-Type": "application/json", "X-Tenant": tenant})
            resp = conn.getresponse()
            replies.append((resp.status, json.loads(resp.read())))
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()
        eng.shutdown(drain=False)
    assert replies[0][0] == 400 and replies[1][0] == 200
    assert np.shape(replies[1][1]["embeddings"]) == (1, 3, 32)
