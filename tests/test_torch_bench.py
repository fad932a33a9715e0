"""The port's benchmark entry point and its tools on the CPU
(``glom_tpu_torch/tools/{bench,mfu,breakdown}.py``), mirroring
``tests/test_cli.py::test_bench_tiny_cpu_end_to_end`` and
``tests/test_tools.py``: one JSON record from the bench at the tiny preset,
no record without a card unless ``--device cpu`` is asked for, glom_tpu's
presets and analytic FLOP count exactly, and the breakdown's rows.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu_torch.config import BENCH_PRESETS, GlomConfig, bench_preset
from glom_tpu_torch.tools import bench, breakdown, mfu

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(*argv):
    # no card visible, wherever the test runs
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "glom_tpu_torch.tools.bench", *argv],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def _records(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def test_bench_tiny_on_the_cpu_prints_one_record():
    """``python -m glom_tpu_torch.tools.bench --config tiny --device cpu``:
    exactly one JSON line, the tiny metric, a positive rate, the resolved
    configuration (ff auto -> dense on the CPU), no TPU figure."""
    out = _run_bench("--config", "tiny", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    (rec,) = _records(out.stdout)
    assert len(out.stdout.strip().splitlines()) == 1
    assert rec["metric"] == "denoise_ssl_train_imgs_per_sec_per_chip_tiny"
    assert rec["status"] == "ok" and rec["backend"] == "cpu" and rec["value"] > 0
    assert rec["unit"] == "imgs/sec/chip"
    assert (rec["dtype"], rec["remat"], rec["remat_policy"], rec["ff_impl"],
            rec["attention_impl"], rec["batch"], rec["steps"], rec["warmup"]) == (
        "bfloat16", True, "dots", "dense", "dense", 8, 2, 1)
    assert rec["mfu"] is None and rec["peak_memory_bytes"] is None
    assert rec["builds_in_window"] == 0 and "error" not in rec
    assert "vs_baseline" not in rec and "last_measured" not in rec


def test_bench_without_a_card_refuses_and_prints_no_record():
    out = _run_bench("--config", "tiny", "--steps", "1", "--warmup", "0")
    assert out.returncode != 0
    assert _records(out.stdout) == [] and "device='cpu'" in out.stderr


def test_bench_refuses_data_images(capsys):
    """``--data images`` streams a folder tree, so it needs one."""
    with pytest.raises(SystemExit):
        bench.parse_args(["--data", "images"])
    assert "--data images needs --data-dir" in capsys.readouterr().err


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """16 JPEGs in two class folders, written with PIL."""
    from PIL import Image

    import numpy as np

    root = tmp_path_factory.mktemp("bench_jpegs")
    rng = np.random.default_rng(0)
    for c in range(2):
        (root / f"c{c}").mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 255, (72, 80, 3), dtype=np.uint8)).save(
                root / f"c{c}" / f"{i}.jpg")
    return str(root)


def test_bench_streams_an_image_tree_under_the_realdata_metric(jpeg_tree):
    """``--data images --data-dir``: one record under the ``_realdata`` name,
    a fresh batch of the tree a step."""
    out = _run_bench("--config", "tiny", "--device", "cpu", "--data", "images", "--data-dir",
                     jpeg_tree, "--data-workers", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    (rec,) = _records(out.stdout)
    assert rec["metric"] == "denoise_ssl_train_imgs_per_sec_per_chip_tiny_realdata"
    assert rec["status"] == "ok" and rec["data"] == "images" and rec["value"] > 0


@pytest.mark.parametrize("decode", ["auto", "python"])
def test_bench_decode_flag_picks_the_decoder(jpeg_tree, decode, monkeypatch, capsys):
    """``--decode auto`` decodes the all-JPEG tree in the native core;
    ``--decode python`` takes the per-file Python decoders and never calls it."""
    from glom_tpu_torch import native

    calls = []
    real = native.decode_jpeg_batch
    monkeypatch.setattr(native, "decode_jpeg_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rec = bench.main(["--config", "tiny", "--device", "cpu", "--data", "images", "--data-dir",
                      jpeg_tree, "--decode", decode, "--steps", "1", "--warmup", "0",
                      "--batch-size", "4", "--data-workers", "2"])
    assert rec["metric"].endswith("_realdata") and _records(capsys.readouterr().out) == [rec]
    assert bool(calls) == (decode == "auto" and native.has_jpeg())


def test_bench_in_process_traces_the_step_phase_outside_the_window(tmp_path, capsys):
    """--profile-dir: three traced steps with the trainer's phase names; the
    kernels' plain versions on the CPU, so no launch is counted."""
    rec = bench.main(["--config", "tiny", "--device", "cpu", "--steps", "1", "--warmup", "0",
                      "--ff-impl", "pallas", "--attention-impl", "pallas", "--fused-ff-bwd",
                      "--fp32", "--no-remat", "--batch-size", "2",
                      "--profile-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"# trace written to {tmp_path}" in out and _records(out) == [rec]
    assert (rec["dtype"], rec["remat"], rec["ff_impl"], rec["fused_ff_bwd"], rec["batch"]) == (
        "float32", False, "pallas", True, 2)
    assert rec["launches_per_step"] == {}
    from glom_tpu_torch.profiling import trace_files

    (path,) = trace_files(str(tmp_path))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"data_wait", "step"} <= names


@pytest.mark.parametrize("name", ["flagship", "large", "tiny"])
def test_bench_preset_is_glom_tpus(name):
    assert bench_preset(name) == jax_config.bench_preset(name)
    assert BENCH_PRESETS[name] == jax_config.BENCH_PRESETS[name]


def _jax_mfu():
    """glom_tpu's tools/mfu.py, loaded by path (it imports jax only in main)."""
    spec = importlib.util.spec_from_file_location("_jax_tools_mfu",
                                                  os.path.join(REPO, "tools", "mfu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["flagship", "large", "tiny"])
@pytest.mark.parametrize("timestep", ["zero", "default", "iters"])
def test_model_flops_per_image_is_glom_tpus(name, timestep):
    kw, iters, _, _ = bench_preset(name)
    t = {"zero": 0, "default": iters // 2 + 1, "iters": iters}[timestep]
    want = _jax_mfu().model_flops_per_image(jax_config.GlomConfig(**kw), t)
    assert mfu.model_flops_per_image(GlomConfig(**kw), t) == want
    assert mfu.train_flops_per_image(GlomConfig(**kw), t) == 3 * want


def test_mfu_peak_comes_from_the_cards_data_sheet_row():
    card = "NVIDIA H100 80GB HBM3"
    assert mfu.peak_tflops(card, torch.bfloat16)[0] == 989.4
    assert mfu.peak_tflops(card, torch.float32)[0] == 66.9
    peak, why = mfu.peak_tflops("NVIDIA A100-SXM4-80GB", torch.bfloat16)
    assert peak is None and "--peak-tflops" in why


def test_mfu_cli(capsys):
    """The analytic line at flagship (7 executed iterations of 12, 265.4 GF
    a train image, as glom_tpu's tool prints), an unknown card refused, and
    the executed count of the plain path's step on the CPU at tiny size."""
    mfu.main(["--imgs-per-sec", "136", "--card", "NVIDIA H100 80GB HBM3", "--fp32",
              "--skip-executed"])
    out = capsys.readouterr().out
    assert "7 executed iterations of 12" in out and "train 265.4 GF" in out
    pct = float(out.split("MFU (model FLOPs)")[1].split("%")[0].split(":")[1])
    assert pct == pytest.approx(100 * 136 * 265.4e9 / 66.9e12, abs=0.1)
    with pytest.raises(SystemExit):
        mfu.main(["--imgs-per-sec", "1", "--card", "unknown", "--skip-executed"])
    assert "--peak-tflops" in capsys.readouterr().err
    mfu.main(["--imgs-per-sec", "10", "--peak-tflops", "1", "--config", "tiny",
              "--batch-size", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    ratio = float(out.split("executed FLOPs/img")[1].split("(x")[1].split(" ")[0])
    assert 1.0 <= ratio < 1.05     # "dots": the products kept, + the decoder's


def test_breakdown_tiny_on_the_cpu(capsys):
    """tests/test_tools.py's component names; the total row reads 100 %."""
    out = breakdown.main(["--config", "tiny", "--device", "cpu", "--repeats", "1"])
    assert json.loads(capsys.readouterr().out) == out
    names = {r["component"] for r in out["rows"]}
    assert {"train_step_total", "forward_capture", "consensus_x_executed",
            "grouped_ff_x_executed", "adam_update", "patch_embed"} <= names
    total = out["rows"][0]
    assert total["component"] == "train_step_total"
    assert total["pct_of_step"] == 100.0 and total["ms"] > 0
    assert out["device"] == "cpu" and out["executed_iters"] == 3
