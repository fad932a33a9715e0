"""The port's session tools against glom_tpu's on the CPU:
``python -m glom_tpu_torch.tools.session_check`` (tools/session_check.py's
counterpart, through the session graph families) and the port's load
generator's ``--sessions``, ``--tenant``, ``--corrupt``, ``--regress-at``
and ``--timeline`` modes (tools/loadgen.py's).

The sweep's equilibrium distances equal glom_tpu's tool on the same
checkpoint and frames within 1e-5; ``--smoke``, ``--require-half`` and a bad
sweep value exit as glom_tpu's do; and the load generator's session and
tenant reports against an in-process port server have tools/loadgen.py's
shape and counts.
"""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from glom_tpu_torch.config import GlomConfig
from glom_tpu_torch.serving.engine import ServingEngine, make_demo_checkpoint
from glom_tpu_torch.serving.server import make_server
from glom_tpu_torch.tools import loadgen, session_check

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = GlomConfig(dim=32, levels=3, image_size=16, patch_size=4)
DISTANCE_ATOL = 1e-5


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_frames_and_sweep_distances_match_glom_tpus_tool(tmp_path):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=TINY, seed=0)
    theirs = _tool("session_check")
    frames = session_check.make_frames(np.random.RandomState(3), 8, 2, 3, 16, 0.1)
    np.testing.assert_array_equal(
        frames, theirs.make_frames(np.random.RandomState(3), 8, 2, 3, 16, 0.1))
    params, config, cold = session_check.build_model(d, None, "cpu")
    ours = session_check.run_sweep(params, config, cold_iters=cold, warm_candidates=[1, 2, 3],
                                   frames=frames, threshold=0.05, burn_in=3, device="cpu")
    jparams, jconfig, jcold = theirs.build_model(d, None)
    want = theirs.run_sweep(jparams, jconfig, cold_iters=jcold, warm_candidates=[1, 2, 3],
                            frames=frames, threshold=0.05, burn_in=3)
    assert cold == jcold == 6
    for a, b in zip(ours, want):
        assert a["warm_iters"] == b["warm_iters"] and a["pass"] == b["pass"]
        for k in ("rel_distance_mean", "rel_distance_max", "rel_distance_transient_max"):
            assert abs(a[k] - b[k]) <= DISTANCE_ATOL, (k, a, b)
    assert sorted(ours[0]) == sorted(want[0])


def test_smoke_exits_0_with_the_half_target_met(capsys):
    assert session_check.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["smoke"] == "ok" and report["half_target_met"]
    assert report["best_warm_iters"] <= report["cold_iters"] // 2


def test_require_half_exits_1_when_no_value_passes(tmp_path, capsys):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=TINY, seed=0)
    rc = session_check.main(["--checkpoint-dir", d, "--warm-iters", "1,2", "--frames", "6",
                             "--threshold", "1e-9", "--require-half", "--device", "cpu",
                             "--report", str(tmp_path / "r.json")])
    assert rc == 1 and "FAIL" in capsys.readouterr().err
    report = json.load(open(tmp_path / "r.json"))
    assert report["best_warm_iters"] is None and not report["half_target_met"]


@pytest.mark.parametrize("argv,code", [(["--warm-iters", "0,2"], 2),
                                       (["--platform", "cpu"], 2)])
def test_bad_arguments_exit_2(tmp_path, argv, code):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=TINY, seed=0)
    try:
        rc = session_check.main(["--checkpoint-dir", d, "--device", "cpu"] + argv)
    except SystemExit as e:
        rc = e.code
    assert rc == code


@pytest.fixture()
def served(tmp_path):
    d = str(tmp_path)
    make_demo_checkpoint(d, config=TINY, seed=0)
    eng = ServingEngine(d, device="cpu", buckets=(1, 2), max_wait_ms=1.0, reload_poll_s=0,
                        warm_iters="auto", tenant_quotas={"a": "4:4"})
    eng.start(watch=False)
    server = make_server(eng)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield "http://{}:{}".format(*server.server_address[:2]), eng
    server.shutdown()
    server.server_close()
    eng.shutdown(drain=False)


def test_loadgen_sessions_report_as_tools_loadgen(served):
    url, eng = served
    out = loadgen.run(url, sessions=3, frames=4, batch_sizes=(1, 2))
    sess = out["session"]
    assert out["requests_ok"] == 12 and out["requests_error"] == 0
    assert (sess["sessions"], sess["cold_ms"]["count"], sess["warm_ms"]["count"]) == (3, 3, 9)
    assert sess["affinity"]["violations"] == [] and not sess["affinity"]["split_sessions"]
    assert eng.registry.snapshot()["serving_session_warm_frames"] == 9
    for si in range(3):     # both generators name their sessions alike: start cold
        assert eng.session_reset(f"lg-sess-{os.getpid()}-{si}")
    theirs = _tool("loadgen")
    results = theirs._Results()
    health = theirs._fetch_health(url, 30)
    theirs.run_sessions([url], theirs._make_image_lists(health, [1, 2]), [1, 2], 3, 4, 30,
                        results)
    want = theirs.session_report(results, [url], 30)
    assert sorted(sess) == sorted(want) and sorted(sess["affinity"]) == sorted(want["affinity"])
    assert (want["cold_ms"]["count"], want["warm_ms"]["count"]) == (3, 9)


def test_loadgen_tenant_report_as_tools_loadgen(served):
    """--tenant a:3 --tenant b:1: per_tenant with tools/loadgen.py's keys;
    tenant a's quota sheds count as sheds, not errors."""
    url, _ = served
    out = loadgen.run(url, tenants=["a:3", "b:1"], requests=24, concurrency=1,
                      batch_sizes=(1,))
    per = out["per_tenant"]
    assert sorted(per) == ["a", "b"] and out["requests_error"] == 0
    assert per["a"]["requests_ok"] + per["a"]["requests_shed"] == 18
    assert per["b"] == {**per["b"], "requests_ok": 6, "requests_shed": 0}
    assert per["a"]["requests_shed"] > 0 and "tenants(a,b)" in out["mode"]
    theirs = _tool("loadgen")
    results = theirs._Results()
    payloads = theirs._make_payloads(theirs._fetch_health(url, 30), [1])
    wall = theirs.run_closed([url], ["embed"], payloads, [1], 8, 1, 30, results,
                             tenants=theirs.parse_tenants(["a:3", "b:1"]))
    want = theirs.report(results, wall, "x")["per_tenant"]
    assert sorted(want) == sorted(per) and sorted(want["a"]) == sorted(per["a"])
    assert loadgen.parse_tenants(["a:3", "b"]) == theirs.parse_tenants(["a:3", "b"])


@pytest.mark.parametrize("flag", [["--fleet"]])
def test_loadgen_runs_the_modes_it_waited_for(flag, capsys):
    """``--smoke --fleet``: a port router in front of a port replica, the
    request's trace stitched across the hop (its spans and parent links;
    the coverage share, wall time on the host, is reported, not gated)."""
    assert loadgen.main(["--smoke", "--device", "cpu", "--min-coverage", "0"] + flag) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["smoke_mode"] == "fleet-stitched" and out["checks"]["hop_links"]
    assert {"router_request", "proxy", "request"} <= set(out["trace_span_names"])
    assert out["parse_router"]["requests_ok"] == 4
    with pytest.raises(SystemExit) as e:
        loadgen.main(flag)  # a fleet is loaded through its router's --url
    assert e.value.code == 2 and "--smoke" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["--corrupt", "--regress-at", "--timeline"])
def test_loadgen_modes_match_tools_loadgens(served, mode, capsys):
    """``--corrupt`` sends tools/loadgen.py's bodies bit for bit, on the same
    requests; ``--regress-at`` steps at the same request index; and
    ``--timeline`` windows the run into the same block.  Each through the
    CLI against a served port engine."""
    url, _ = served
    theirs = _tool("loadgen")
    health = theirs._fetch_health(url, 30)
    argv = ["--url", url, "--requests", "8", "--concurrency", "1", "--batch-sizes", "1,2"]
    if mode == "--corrupt":
        ours_b = loadgen.make_corrupt_payloads(health, [1, 2])
        assert ours_b == theirs._make_corrupt_payloads(health, [1, 2])
        picks = [i for i in range(40) if loadgen.corrupt_this(i, 0.3)]
        assert picks == [i for i in range(40) if theirs._corrupt_this(i, 0.3)] and len(picks) == 12
        argv += ["--corrupt", "0.5"]
    elif mode == "--regress-at":
        argv += ["--regress-at", "0.5"]
    else:
        argv += ["--timeline", "--timeline-step-s", "0.5"]
    assert loadgen.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["requests_ok"] == 8 and out["requests_error"] == 0
    if mode == "--corrupt":
        assert out["requests_corrupted"] == 4 and "corrupt(0.5)" in out["mode"]
    elif mode == "--regress-at":
        # glom_tpu's rule: from ceil(n * frac) on, the largest size
        assert out["regress"] == {"frac": 0.5, "from_request": 4, "batch_size": 2}
        assert out["requests_regressed"] == 4 and out["images_ok"] == (1 + 2) * 2 + 2 * 4
    else:
        results = theirs._Results(timeline=True)
        payloads = theirs._make_payloads(health, [1, 2])
        theirs.run_closed([url], ["embed"], payloads, [1, 2], 8, 1, 30, results)
        want = theirs.timeline_report(results, 0.5)
        got = out["timeline"]
        assert got["step_s"] == want["step_s"] == 0.5
        assert sorted(got["windows"][0]) == sorted(want["windows"][0])
        assert sum(w["requests_ok"] for w in got["windows"]) == 8
