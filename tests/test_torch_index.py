"""The port's copy of the level index (glom_tpu_torch.hierarchy.index):
glom_tpu's index-store cases run against it, files written by either copy
read in the other, and the module loads on its own (stdlib + numpy, no
torch, nothing of the port)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from glom_tpu.hierarchy import index as jax_index
from glom_tpu_torch.hierarchy import index
from glom_tpu_torch.hierarchy.index import (
    INDEX_PART_RE,
    LevelIndex,
    assemble_level,
    index_part_name,
    level_parts,
    write_index_parts,
)

SOURCE = index.__file__


def _states(k, n=2, levels=2, dim=3, seed=0):
    return np.random.RandomState(seed).randn(k, n, levels, dim).astype(np.float32)


def test_part_name_round_trips_through_the_pattern():
    m = INDEX_PART_RE.match(index_part_name(2, 0, 1024))
    assert m and (int(m.group("level")), int(m.group("lo")), int(m.group("hi"))) == (2, 0, 1024)
    assert index_part_name(2, 0, 1024) == jax_index.index_part_name(2, 0, 1024)


def test_top_level_entries_are_patch_means(tmp_path):
    root = str(tmp_path / "idx")
    states = _states(4)
    write_index_parts(root, 0, 4, states)
    below = np.load(level_parts(root, 0)[0][2])
    top = np.load(level_parts(root, 1)[0][2])
    assert below.shape == (4, 2, 3)
    assert top.shape == (4, 1, 3)
    np.testing.assert_allclose(top, states[:, :, 1, :].mean(axis=1, keepdims=True))


def test_write_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError, match="states"):
        write_index_parts(str(tmp_path), 0, 4, _states(3))


def test_rewrite_is_idempotent_and_orphans_unlink(tmp_path):
    """A dead owner's orphan chunk at other boundaries vanishes when the
    re-cut chunks land, per level family; leftover tmp files do not remain."""
    root = str(tmp_path / "idx")
    write_index_parts(root, 0, 8, _states(8, seed=1))
    a, b = _states(4, seed=2), _states(4, seed=3)
    write_index_parts(root, 0, 4, a)
    write_index_parts(root, 4, 8, b)
    write_index_parts(root, 4, 8, b)
    for level in (0, 1):
        assert [(lo, hi) for lo, hi, _ in level_parts(root, level)] == [(0, 4), (4, 8)]
    np.testing.assert_array_equal(assemble_level(root, 0, total=8),
                                  np.concatenate([a[:, :, 0, :], b[:, :, 0, :]]))
    assert not [f for f in os.listdir(root) if f.endswith(".tmp")]


def test_assemble_rejects_gap_and_short_cover(tmp_path):
    root = str(tmp_path / "idx")
    with pytest.raises(ValueError, match="no level"):
        assemble_level(root, 0)
    write_index_parts(root, 2, 4, _states(2))
    with pytest.raises(ValueError, match="tile"):
        assemble_level(root, 0)
    root2 = str(tmp_path / "idx2")
    write_index_parts(root2, 0, 2, _states(2))
    with pytest.raises(ValueError, match="total"):
        assemble_level(root2, 0, total=4)


def test_query_validation(tmp_path):
    idx = LevelIndex(str(tmp_path), levels=2)
    with pytest.raises(ValueError, match="outside"):
        idx.query(np.zeros(3), level=2)
    with pytest.raises(ValueError, match="k >= 1"):
        idx.query(np.zeros(3), level=0, k=0)


def test_query_exact_match_wins_and_ties_break_by_slot(tmp_path):
    root = str(tmp_path / "idx")
    states = np.zeros((3, 1, 1, 3), np.float32)
    states[0, 0, 0] = [0.0, 1.0, 0.0]
    states[1, 0, 0] = [1.0, 0.0, 0.0]
    states[2, 0, 0] = [1.0, 0.0, 0.0]
    write_index_parts(root, 0, 3, states)
    got = LevelIndex(root, levels=1).query(np.asarray([1.0, 0.0, 0.0]), level=0, k=2)
    assert [r["slot"] for r in got] == [1, 2]
    assert got[0]["score"] == pytest.approx(1.0)


def test_query_sees_parts_landed_after_construction(tmp_path):
    root = str(tmp_path / "idx")
    early = np.zeros((2, 1, 1, 3), np.float32)
    early[:, 0, 0] = [0.0, 1.0, 0.0]
    write_index_parts(root, 0, 2, early)
    idx = LevelIndex(root, levels=1)
    q = np.asarray([1.0, 0.0, 0.0])
    assert idx.query(q, level=0, k=1)[0]["score"] < 0.5
    late = np.zeros((2, 1, 1, 3), np.float32)
    late[0, 0, 0] = [1.0, 0.0, 0.0]
    write_index_parts(root, 2, 4, late)
    top = idx.query(q, level=0, k=1)[0]
    assert top["slot"] == 2 and top["score"] == pytest.approx(1.0)


def test_stats_counts_chunks_and_slots(tmp_path):
    root = str(tmp_path / "idx")
    write_index_parts(root, 0, 2, _states(2))
    write_index_parts(root, 2, 5, _states(3))
    st = LevelIndex(root, levels=2).stats()
    assert st["chunks"] == {"0": 2, "1": 2}
    assert st["slots"] == {"0": 5, "1": 5}


@pytest.mark.parametrize("writer", ["port", "glom_tpu"])
def test_either_copy_reads_the_others_files(tmp_path, writer):
    """Bitwise the same part files, the same assembly and the same answers."""
    w, r = (index, jax_index) if writer == "port" else (jax_index, index)
    root, mirror = str(tmp_path / "idx"), str(tmp_path / "mirror")
    chunks = [(0, 3, _states(3, n=4, levels=3, dim=8, seed=1)),
              (3, 7, _states(4, n=4, levels=3, dim=8, seed=2))]
    for lo, hi, s in chunks:
        w.write_index_parts(root, lo, hi, s)
        r.write_index_parts(mirror, lo, hi, s)
    for level in range(3):
        for (_, _, p), (_, _, q) in zip(r.level_parts(root, level), w.level_parts(mirror, level)):
            with open(p, "rb") as f, open(q, "rb") as g:
                assert f.read() == g.read()
        np.testing.assert_array_equal(r.assemble_level(root, level, total=7),
                                      w.assemble_level(root, level, total=7))
    queries = np.random.RandomState(9).randn(2, 8).astype(np.float32)
    for level in range(3):
        assert (r.LevelIndex(root, 3).query(queries, level, k=4)
                == w.LevelIndex(root, 3).query(queries, level, k=4))
    assert r.LevelIndex(root, 3).stats()["slots"] == {"0": 7, "1": 7, "2": 7}


def test_the_copy_imports_only_the_stdlib_and_numpy():
    with open(SOURCE) as f:
        tree = ast.parse(f.read(), SOURCE)
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".")[0])
    assert imported == {"__future__", "os", "re", "typing", "numpy"}


def test_the_copy_loads_on_its_own(tmp_path):
    """Loaded by path in a fresh interpreter it works and pulls in neither
    torch nor the port."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('level_index', {SOURCE!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "import numpy as np\n"
        f"mod.write_index_parts({str(tmp_path)!r}, 0, 2, np.ones((2, 4, 2, 3), np.float32))\n"
        f"print(mod.LevelIndex({str(tmp_path)!r}, 2).stats()['slots'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'glom_tpu_torch', "
        "'jax', 'glom_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "{'0': 2, '1': 2}"
