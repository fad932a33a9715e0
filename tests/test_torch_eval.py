"""The port's held-out evaluation against ``glom_tpu``'s, and the trainer's
eval phase and CLI.

``training/eval.py`` against ``glom_tpu/training/eval.py`` on the same
weights, images and noise: the held-out split (the same lists), the
embeddings, the ridge probe (weights within 1e-4 relative, the same
accuracies on well-separated classes, with and without ``l2_grid``), the
denoising PSNR and ``EvalSuite.run`` (the same keys, values within 1e-4).
Then the trainer: ``eval_every`` logs the suite's record or the incoming
batch's PSNR, and draws nothing from the train step's generator; and the
CLI trains on an image tree with the held-out suite.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glom_tpu import config as jax_config
from glom_tpu.training import eval as jax_eval
from glom_tpu_torch import convert
from glom_tpu_torch.config import GlomConfig, TrainConfig
from glom_tpu_torch.serving.engine import demo_params
from glom_tpu_torch.training import eval as port_eval
from glom_tpu_torch.training import train
from glom_tpu_torch.training.metrics import MetricLogger
from glom_tpu_torch.training.trainer import Trainer

# tier-1 runs these files beside the JAX suite under several workers; one
# intra-op thread each keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

TINY = dict(dim=32, levels=3, image_size=16, patch_size=4)
RTOL = 1e-4
PROBE_KEYS = {"eval_psnr_db", "probe_train_acc", "probe_test_acc", "probe_all_train_acc",
              "probe_all_test_acc"}


def _tree(seed=3):
    return demo_params(GlomConfig(**TINY), TrainConfig(), seed=seed)


def _port(tree):
    return convert.params_from_numpy(tree, GlomConfig(**TINY), "cpu")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _classes(n, k=3, seed=0, noise=0.3):
    """``n`` images of ``k`` classes: a fixed random pattern a class plus noise."""
    rng = np.random.default_rng(seed)
    patterns = rng.standard_normal((k, 3, 16, 16)).astype(np.float32)
    labels = np.arange(n) % k
    imgs = patterns[labels] + noise * rng.standard_normal((n, 3, 16, 16)).astype(np.float32)
    return imgs.astype(np.float32), labels


def test_holdout_split_is_glom_tpu_s():
    files = [f"d/c{i % 4}/{i:03d}.jpg" for i in range(97)]
    for fraction, seed in ((0.02, 0), (0.3, 5)):
        assert port_eval.holdout_split(files, fraction, seed=seed) == jax_eval.holdout_split(
            files, fraction, seed=seed)


def test_embeddings_match_glom_tpu():
    tree, cfg = _tree(), GlomConfig(**TINY)
    imgs, _ = _classes(4)
    want = np.asarray(jax_eval.embed_levels(_jnp(tree["glom"]), jnp.asarray(imgs),
                                            config=jax_config.GlomConfig(**TINY), iters=4))
    got = port_eval.embed_levels(_port(tree)["glom"], torch.from_numpy(imgs), config=cfg,
                                 iters=4)
    assert not got.requires_grad and got.shape == (4, 3, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    top = port_eval.embed(_port(tree)["glom"], torch.from_numpy(imgs), config=cfg, iters=4, level=1)
    np.testing.assert_allclose(top.numpy(), want[:, 1], rtol=RTOL, atol=RTOL)


def _separated(n, d, k=4, seed=1):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((k, d))
    y = rng.integers(0, k, n)
    return (centers[y] + rng.standard_normal((n, d))).astype(np.float32), y


@pytest.mark.parametrize("d", [16, 96])
@pytest.mark.parametrize("grid", [None, [1e-3, 1.0, 100.0]])
def test_linear_probe_matches_glom_tpu(d, grid):
    """The same accuracies on well-separated classes; at ``d=96`` over 40
    training rows the Gram is rank-deficient, as the all-levels probe's is,
    and ``l2·I`` alone makes the system solvable."""
    feats, labels = _separated(70, d)
    x, y, xt, yt = feats[:40], labels[:40], feats[40:], labels[40:]
    kw = dict(num_classes=4, l2_grid=grid)
    want = jax_eval.linear_probe(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), jnp.asarray(yt),
                                 **kw)
    assert want[1] > 0.9   # well separated: no near tie to flip
    # the same accuracies: a fraction of the same count, to float32's mean
    np.testing.assert_allclose(port_eval.linear_probe(x, y, xt, yt, **kw), want, rtol=1e-6)
    np.testing.assert_allclose(port_eval.linear_probe(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xt), torch.from_numpy(yt),
        **kw), want, rtol=1e-6)


@pytest.mark.parametrize("d,l2", [(16, 1e-3), (16, 1.0), (96, 100.0)])
def test_ridge_weights_match_glom_tpu(d, l2):
    """The standardized features and the solve's weights within 1e-4 relative
    of glom_tpu's, where float32 can hold them: at ``d=96`` over 40 rows and
    ``l2=1e-3`` the system's condition is about 1e6, and each package's
    float32 solve is about 10 % off the float64 one (its null-space part), so
    there only the accuracies above are held."""
    feats, labels = _separated(70, d)
    x, y, xt = feats[:40], labels[:40], feats[40:]
    sx, _ = port_eval.standardize(x, xt)
    jx = np.asarray((jnp.asarray(x) - jnp.asarray(x).mean(0)) / (jnp.asarray(x).std(0) + 1e-6))
    np.testing.assert_allclose(sx.numpy(), jx, rtol=RTOL, atol=1e-5)
    onehot = np.eye(4, dtype=np.float32)[y]
    w = port_eval.ridge_weights(sx, torch.from_numpy(onehot), l2).numpy()
    jw = np.asarray(jnp.linalg.solve(jnp.asarray(jx.T @ jx) + l2 * jnp.eye(d),
                                     jnp.asarray(jx.T @ onehot)))
    assert np.linalg.norm(w - jw) / np.linalg.norm(jw) <= RTOL


def test_linear_probe_grid_needs_five_validation_rows():
    """Below 5 validation rows the fixed ``l2`` stands, as in glom_tpu."""
    x, y = _separated(20, 8)
    grid = [1e6]
    kw = dict(num_classes=4)
    assert port_eval.linear_probe(x, y, x, y, l2_grid=grid, **kw) == port_eval.linear_probe(
        x, y, x, y, l2=1e6, **kw)
    few_x, few_y = x[:12], y[:12]
    assert port_eval.linear_probe(few_x, few_y, x, y, l2_grid=grid, **kw) == \
        port_eval.linear_probe(few_x, few_y, x, y, **kw)


def test_psnr_matches_glom_tpu():
    tree = _tree()
    imgs, _ = _classes(4)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, imgs.shape, jnp.float32))
    kw = dict(noise_std=0.7, iters=4, timestep=2, level=-1)
    want = float(jax.jit(jax_eval.make_psnr_fn(jax_config.GlomConfig(**TINY), **kw))(
        _jnp(tree), jnp.asarray(imgs), key))
    fn = port_eval.make_psnr_fn(GlomConfig(**TINY), **kw)
    got = fn(_port(tree), torch.from_numpy(imgs), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    got = port_eval.reconstruction_psnr(_port(tree), torch.from_numpy(imgs),
                                        config=GlomConfig(**TINY),
                                        noise=torch.from_numpy(noise), **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    a = fn(_port(tree), torch.from_numpy(imgs), generator=torch.Generator().manual_seed(1))
    b = fn(_port(tree), torch.from_numpy(imgs), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and np.isfinite(float(a))


@pytest.mark.parametrize("grid", [None, [0.01, 1.0]])
def test_eval_suite_matches_glom_tpu(grid):
    """``EvalSuite.run``: the PSNR over chunks (glom_tpu's per-chunk noise
    handed in), the 0xB0BE split, chunked embeddings and both probes."""
    tree = _tree(seed=5)
    psnr_imgs, _ = _classes(20, seed=3)
    # 240 probe images: 120 probe-train rows over the all-levels probe's 96
    # features, a well-posed solve; classes separated well enough that no
    # accuracy rests on a near tie
    probe_imgs, labels = _classes(240, seed=4, noise=1.0)
    kw = dict(probe_images=probe_imgs, probe_labels=labels, probe_l2_grid=grid, noise_std=0.5,
              iters=4, chunk=8)
    ref = jax_eval.EvalSuite(jax_config.GlomConfig(**TINY), psnr_imgs, **kw)
    key = jax.random.PRNGKey(11)
    want = ref.run(_jnp(tree), key)
    noise = np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                         (8, 3, 16, 16), jnp.float32))
                            for i in (0, 8)])
    suite = port_eval.EvalSuite(GlomConfig(**TINY), psnr_imgs, **kw)
    got = suite.run(_port(tree), noise=noise)
    assert set(got) == set(want) == PROBE_KEYS
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(suite.probe_labels, ref.probe_labels)
    with pytest.raises(ValueError, match="probe_labels"):
        port_eval.EvalSuite(GlomConfig(**TINY), psnr_imgs, probe_images=probe_imgs)


def _trainer(stream=None, **kw):
    train_cfg = TrainConfig(batch_size=2, steps=4, log_every=1, seed=0, **kw)
    return Trainer(GlomConfig(**TINY), train_cfg, device="cpu",
                   logger=MetricLogger(stream=stream or io.StringIO()))


def _records(stream):
    return [json.loads(line) for line in stream.getvalue().splitlines()]


def test_trainer_eval_every_logs_and_leaves_training_alone():
    """With a suite the eval records carry its keys; without one, the
    incoming batch's ``psnr_db``.  Either way the losses are the bits of a
    run without eval: eval draws from a generator of its own."""
    imgs = [np.random.default_rng(i).standard_normal((2, 3, 16, 16)).astype(np.float32)
            for i in range(4)]
    psnr_imgs, _ = _classes(8, seed=6)
    probe_imgs, labels = _classes(12, seed=7)
    runs = {}
    for name in ("none", "suite", "psnr"):
        stream = io.StringIO()
        trainer = _trainer(stream, eval_every=0 if name == "none" else 2)
        if name == "suite":
            trainer.set_eval_suite(port_eval.EvalSuite(
                GlomConfig(**TINY), psnr_imgs, probe_images=probe_imgs, probe_labels=labels,
                chunk=4))
        trainer.fit(iter(imgs))
        runs[name] = _records(stream)
    losses = {k: [r["loss"] for r in v if "loss" in r] for k, v in runs.items()}
    assert losses["suite"] == losses["psnr"] == losses["none"] and len(losses["none"]) == 4
    evals = [r for r in runs["suite"] if "eval_psnr_db" in r]
    assert [r["step"] for r in evals] == [2, 4] and set(evals[0]) >= PROBE_KEYS
    psnrs = [r for r in runs["psnr"] if "psnr_db" in r]
    assert [r["step"] for r in psnrs] == [2, 4] and all(np.isfinite(r["psnr_db"]) for r in psnrs)
    timed = [r for r in runs["suite"] if "t_eval" in r]
    assert [r["step"] for r in timed] == [2, 4]


def test_cli_trains_on_an_image_tree_with_the_held_out_suite(tmp_path, capsys):
    """``--data images --eval-every`` carves glom_tpu's held-out split, labels
    the probe from the class folders and logs the suite's record; the CLI
    takes the consistency and data flags."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(2):
        (tmp_path / "tree" / f"k{c}").mkdir(parents=True)
        for i in range(16):
            arr = np.clip(rng.normal(80 + 90 * c, 25, (20, 20, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / "tree" / f"k{c}" / f"{i}.png")
    log = tmp_path / "log.jsonl"
    final = train.main([
        "--dim", "32", "--levels", "3", "--image-size", "16", "--patch-size", "4",
        "--batch-size", "4", "--steps", "2", "--log-every", "1", "--device", "cpu",
        "--data", "images", "--data-dir", str(tmp_path / "tree"), "--augment", "flip",
        "--eval-every", "2", "--eval-holdout", "0.5", "--probe-examples", "12",
        "--probe-l2-grid", "0.1", "10", "--consistency", "infonce",
        "--consistency-weight", "0.2", "--log-file", str(log)])
    assert np.isfinite(final["loss"])
    records = [json.loads(line) for line in log.read_text().splitlines()]
    evals = [r for r in records if "eval_psnr_db" in r]
    assert len(evals) == 1 and set(evals[0]) >= PROBE_KEYS
    args = train.parse_args(["--data", "folder", "--data-dir", "x", "--consistency", "mse",
                             "--eval-every", "5"])
    assert (args.eval_holdout, args.probe_examples, args.eval_max_images) == (0.02, 256, 1024)
    with pytest.raises(SystemExit):
        train.parse_args(["--data", "images"])
    assert "--data images needs --data-dir" in capsys.readouterr().err
