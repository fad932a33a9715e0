"""The port's chaos suite (``glom_tpu_torch/tools/chaos.py``) on the CPU:
each of its fourteen scenarios recovers in its smoke variant, the two
checkpoint scenarios and the three elastic ones give ``glom_tpu``'s records
(``tools/chaos.py``) on the same seeds but for their wall clocks, and
without a card the tool runs nothing.  Every scenario but the elastic ones
runs in this process, as ``run`` drives it; the elastic ones run on the gloo
world of four CPU ranks ``run`` starts.  No wall-clock gate here beyond the
scenarios' own."""

import importlib.util
import json
import os

import pytest
import torch

from glom_tpu_torch.tools import chaos

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _glom_tpu_chaos():
    spec = importlib.util.spec_from_file_location(
        "glom_tpu_chaos", os.path.join(ROOT, "tools", "chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_registry_keeps_glom_tpus_names_and_order():
    ref = _glom_tpu_chaos()
    assert list(chaos.SCENARIOS) == list(ref.SCENARIOS)
    assert chaos.ELASTIC == ("host_preempt", "coordinator_loss", "shrink_restart")
    assert chaos.PORTED == tuple(ref.SCENARIOS) and len(chaos.PORTED) == 14


@pytest.mark.parametrize("name", [n for n in chaos.PORTED if n not in chaos.ELASTIC])
def test_scenario_recovers_in_its_smoke_variant(name):
    (rec,) = chaos.run([name], soak=False, device="cpu", quiet=True)
    assert rec["scenario"] == name
    assert rec["outcome"] == "recovered", rec.get("traceback", rec)
    assert rec["mttr_s"] >= 0.0 and rec["wall_s"] >= rec["mttr_s"] - 1e-3


def test_a_replica_listens_outside_the_ephemeral_range_and_keeps_its_port():
    """replica_kill restarts its victim on the victim's port: a port from
    the ephemeral range can be the local end of one of the load's outgoing
    connections by then, so replicas take ports outside it; a taken
    candidate is skipped, a taken fixed port raises."""
    import errno

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = map(int, f.read().split())
    ports = chaos._fixed_ports()
    assert len(set(ports)) == len(ports) > 1000
    assert all(1024 <= p < lo or hi < p <= 65535 for p in ports)
    tried = []

    def make(port):
        tried.append(port)
        if len(tried) < 3:
            raise OSError(errno.EADDRINUSE, "taken")
        return port

    assert chaos._bind(make) == tried[2] and len(set(tried)) == 3
    tried.clear()
    with pytest.raises(OSError):
        chaos._bind(make, 4242)
    assert tried == [4242]


@pytest.mark.parametrize("name", ["torn_ckpt_write", "corrupt_restore"])
def test_checkpoint_scenarios_match_glom_tpus_records(name):
    """The same fault plan against both packages' trainers: the same resume
    step, the same completed step; only the clocks differ."""
    ref = _glom_tpu_chaos()
    (theirs,) = ref.run([name], soak=False, quiet=True)
    (ours,) = chaos.run([name], soak=False, device="cpu", quiet=True)
    clocks = ("mttr_s", "wall_s")
    assert theirs["outcome"] == "recovered", theirs
    assert ({k: v for k, v in ours.items() if k not in clocks}
            == {k: v for k, v in theirs.items() if k not in clocks})
    assert set(ours) == set(theirs)


@pytest.fixture(scope="module")
def elastic_records():
    """The three elastic scenarios of both packages: the port's on its gloo
    world of four CPU ranks (one world for the three, as ``run`` groups
    them), ``glom_tpu``'s in this process on its faked devices."""
    ours = chaos.run(list(chaos.ELASTIC), soak=False, device="cpu", quiet=True)
    theirs = _glom_tpu_chaos().run(list(chaos.ELASTIC), soak=False, quiet=True)
    return {r["scenario"]: r for r in ours}, {r["scenario"]: r for r in theirs}


@pytest.mark.parametrize("name", ["host_preempt", "coordinator_loss", "shrink_restart"])
def test_each_elastic_scenario_recovers_with_glom_tpus_record(elastic_records, name):
    """glom_tpu's assertions hold on every rank, every rank's supervisor
    state (plans, domains, counters, MTTR) is equal, and the record is
    glom_tpu's: restarts, victim and survivor steps, elections and the new
    coordinator, re-plans, the re-planned mesh and the resume step, and the
    MTTR on the simulated clock (exact; only the wall clocks differ)."""
    ours, theirs = (r[name] for r in elastic_records)
    assert ours["outcome"] == "recovered", ours.get("traceback", ours)
    assert theirs["outcome"] == "recovered", theirs
    assert ours["world"] == chaos.ELASTIC_WORLD
    clocks = ("wall_s", "recovery_wall_s")
    assert ({k: v for k, v in ours.items() if k not in clocks + ("world",)}
            == {k: v for k, v in theirs.items() if k not in clocks})


def test_without_a_card_the_default_device_runs_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chaos.main(["--smoke", "--scenario", "reload_io_error"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_cli_summary_line_and_json(tmp_path, capsys):
    path = str(tmp_path / "chaos.json")
    assert chaos.main(["--smoke", "--device", "cpu", "--scenario", "reload_io_error",
                       "--scenario", "train_crash", "--json", path]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"mode": "smoke", "recovered": 2, "total": 2}
    assert [json.loads(line)["scenario"] for line in lines[:-1]] == ["reload_io_error",
                                                                     "train_crash"]
    with open(path) as f:
        summary = json.load(f)
    assert [r["outcome"] for r in summary["results"]] == ["recovered"] * 2
