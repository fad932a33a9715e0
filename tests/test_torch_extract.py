"""The port's extraction CLI (``python -m glom_tpu_torch.training.extract``)
against glom_tpu's on the CPU.

One PNG tree (written as ``tests/test_cli.py`` writes it) and one
checkpoint from glom_tpu's train CLI (dim=32, levels=3, 16x16 images,
2 iterations) go through both CLIs: the ``.npz`` keys other than the
embeddings are identical, the embeddings within 1e-5 absolute (a forward of
2 iterations and a mean over 16 patches).  A checkpoint written by the
port's trainer extracts through both CLIs the same way.
"""

import json

import numpy as np
import pytest
import torch

from glom_tpu.training.extract import main as jax_extract
from glom_tpu.training.train import main as jax_train
from glom_tpu_torch.training import denoise
from glom_tpu_torch.training import extract
from glom_tpu_torch.training import train as port_train
from tests.conftest import write_image

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

EMB_ATOL = 1e-5
MODEL = ["--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
         "--iters", "2"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """8 PNG images in two class folders, and a one-step checkpoint of
    glom_tpu's train CLI."""
    root = tmp_path_factory.mktemp("extract")
    data = root / "data"
    rng = np.random.default_rng(0)
    for i in range(8):
        sub = data / f"class_{i % 2}"
        sub.mkdir(parents=True, exist_ok=True)
        write_image(sub / f"img_{i}.png", rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    ckpt = root / "ckpt"
    jax_train(["--steps", "1", "--batch-size", "8", *MODEL, "--log-every", "0",
               "--checkpoint-dir", str(ckpt), "--checkpoint-every", "1"])
    return root, data, ckpt


def _both(tmp_path, capsys, ckpt, data, flags):
    """Run both CLIs with ``flags``; returns their npz files and JSON lines."""
    out = {}
    for name, main, extra in (("jax", jax_extract, []),
                              ("port", extract.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.npz"
        capsys.readouterr()
        main(["--checkpoint-dir", str(ckpt), "--data-dir", str(data), "--out", str(path),
              *flags, *extra])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out[name] = (np.load(str(path), allow_pickle=False), line)
    return out


def _assert_same(out):
    (want, want_line), (got, got_line) = out["jax"], out["port"]
    assert sorted(got.files) == sorted(want.files) == sorted(
        ["embeddings", "labels", "class_names", "paths", "checkpoint_step", "level"])
    for key in ("labels", "class_names", "paths", "checkpoint_step", "level"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    assert got["embeddings"].dtype == np.float32
    assert got["embeddings"].shape == want["embeddings"].shape
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], atol=EMB_ATOL)
    assert {k: v for k, v in got_line.items() if k != "out"} == {
        k: v for k, v in want_line.items() if k != "out"}
    return got


@pytest.mark.parametrize("flags, shape", [
    (["--batch-size", "3"], (8, 32)),
    (["--all-levels"], (8, 3, 32)),
    (["--level", "0", "--batch-size", "8"], (8, 32)),
    (["--max-images", "5", "--batch-size", "2"], (5, 32)),
])
def test_both_clis_write_the_same_npz(tree, tmp_path, capsys, flags, shape):
    _, data, ckpt = tree
    got = _assert_same(_both(tmp_path, capsys, ckpt, data, flags))
    assert got["embeddings"].shape == shape
    assert int(got["checkpoint_step"]) == 1
    assert int(got["level"]) == (-999 if "--all-levels" in flags else
                                 0 if "--level" in flags else -1)
    assert list(got["class_names"]) == ["class_0", "class_1"]


def test_a_checkpoint_of_the_ports_trainer_extracts(tree, tmp_path, capsys):
    _, data, _ = tree
    ckpt = tmp_path / "port_ckpt"
    port_train.main(["--steps", "2", "--batch-size", "4", *MODEL, "--log-every", "0",
                     "--ff-impl", "pallas", "--attention-impl", "pallas", "--device", "cpu",
                     "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2"])
    got = _assert_same(_both(tmp_path, capsys, ckpt, data, ["--all-levels"]))
    assert int(got["checkpoint_step"]) == 2
    # the CLI's rows are extract_embeddings' on the decoded tree
    step, config, _, params = denoise.load_checkpoint_state(str(ckpt), device="cpu")
    assert config.ff_impl == config.attention_impl == "pallas"
    files = [str(p) for p in got["paths"]]
    direct = extract.extract_embeddings(
        params["glom"], config, extract.decoded_batches(files, 8, config.image_size),
        all_levels=True)
    np.testing.assert_array_equal(direct, got["embeddings"])


def test_extract_embeddings_needs_no_padding_for_the_tail(tree):
    """Uneven batches give the rows one batch gives."""
    _, _, ckpt = tree
    _, config, _, params = denoise.load_checkpoint_state(str(ckpt), device="cpu")
    imgs = np.random.default_rng(3).standard_normal((7, 3, 16, 16)).astype(np.float32)
    whole = extract.extract_embeddings(params["glom"], config, [imgs], level=1)
    parts = extract.extract_embeddings(params["glom"], config,
                                       [imgs[:3], imgs[3:6], torch.from_numpy(imgs[6:])],
                                       level=1)
    assert whole.shape == (7, 32) and whole.dtype == np.float32
    np.testing.assert_allclose(parts, whole, atol=1e-6)


def test_platform_is_refused_by_name(tree, capsys):
    _, data, ckpt = tree
    with pytest.raises(SystemExit):
        extract.main(["--checkpoint-dir", str(ckpt), "--data-dir", str(data),
                      "--platform", "cpu"])
    assert "--platform is not in the port" in capsys.readouterr().err
