"""The port's chaos suite (``glom_tpu_torch/tools/chaos.py``) on the CPU:
each of its eleven scenarios recovers in its smoke variant, the two
checkpoint scenarios give ``glom_tpu``'s records (``tools/chaos.py``) on the
same seeds but for their clocks, the three elastic scenarios keep their
names and are refused, and without a card the tool runs nothing.  Every
scenario runs in this process, as ``run`` drives it; no wall-clock gate
here beyond the scenarios' own."""

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
    assert len(chaos.PORTED) == 11 and not set(chaos.PORTED) & set(chaos.ELASTIC)


@pytest.mark.parametrize("name", chaos.PORTED)
def test_scenario_recovers_in_its_smoke_variant(name):
    (rec,) = chaos.run([name], soak=False, device="cpu", quiet=True)
    assert rec["scenario"] == name
    assert rec["outcome"] == "recovered", rec.get("traceback", rec)
    assert rec["mttr_s"] >= 0.0 and rec["wall_s"] >= rec["mttr_s"] - 1e-3


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


@pytest.mark.parametrize("name", ["host_preempt", "coordinator_loss", "shrink_restart"])
def test_an_elastic_scenario_exits_2_naming_its_roadmap_item(name, capsys):
    with pytest.raises(SystemExit) as e:
        chaos.main(["--smoke", "--device", "cpu", "--scenario", name])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert name in err and "ROADMAP queue 1, item 6" in err and "resilience/elastic.py" in err


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
