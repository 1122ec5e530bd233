"""The port's host data loader (``datasets/{samplers,collate,catalog}.py``,
``make_data_loader``, ``RayBankDataset.__getitem__``) against the JAX one:
on a 16x16 procedural scene, the same config and seeds yield the same
batches, bitwise. Also the ``run --type dataset`` entry and the refusal of
``is_distributed``."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from test_torch_helpers import LEGO, jax_make_cfg

from nerf_replication_tpu.datasets import make_data_loader as jax_loader
from nerf_replication_tpu.datasets import samplers as jax_samplers
from nerf_replication_tpu.datasets.catalog import DatasetCatalog as JaxCatalog
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets import make_data_loader
from nerf_replication_tpu_torch.datasets import samplers
from nerf_replication_tpu_torch.datasets.catalog import DatasetCatalog
from nerf_replication_tpu_torch.datasets.collate import (
    default_collate,
    make_collator,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene

    root = str(tmp_path_factory.mktemp("loader_scene"))
    generate_scene(root, "procedural", H=16, W=16, n_train=5, n_test=3)
    return root


@pytest.fixture(autouse=True)
def numpy_ray_bank(monkeypatch):
    """The JAX Dataset builds its bank with its C++ builder where g++ is
    present, which rounds differently from its numpy builder by up to 6e-8
    (ROADMAP Queue 3); the port's bank is bitwise the numpy one
    (``test_torch_data.py``). Pin the JAX side to numpy so the loaders
    compare bitwise."""
    import nerf_replication_tpu.native as jax_native

    monkeypatch.setattr(jax_native, "get_lib", lambda: None)


def _opts(root, extra=()):
    return ["scene", "procedural",
            "train_dataset.data_root", root, "test_dataset.data_root", root,
            "train_dataset.H", "16", "train_dataset.W", "16",
            "test_dataset.H", "16", "test_dataset.W", "16",
            "test_dataset.cams", "[0, -1, 1]", *extra]


def _both(root, extra=()):
    opts = _opts(root, extra)
    return make_cfg(LEGO, opts), jax_make_cfg(LEGO, opts)


def _assert_batches_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_batches_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_batches_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("batch_size", [1, 3])
def test_train_split_batches_bitwise(scene, batch_size):
    """The train item draws 1024 rays from numpy's global RNG: seeded the
    same before each loader, both yield the same batches (a shuffled
    sampler over the 5 images, capped by ``max_iter``)."""
    ours, ref = _both(scene, ["train.batch_size", str(batch_size)])
    np.random.seed(7)
    mine = list(make_data_loader(ours, "train", max_iter=4))
    np.random.seed(7)
    theirs = list(jax_loader(ref, "train", max_iter=4))
    assert len(mine) == len(theirs) == 4
    assert mine[0]["rays"].shape[0] == batch_size
    for a, b in zip(mine, theirs):
        assert a["rays"].shape[1:] == (1024, 6)
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("workers", [0, 2])
def test_test_split_batches_bitwise(scene, workers):
    """The test split: whole images in order (a sequential sampler), the
    prefetch threads changing nothing."""
    extra = ["test.num_workers", str(workers)]
    ours, ref = _both(scene, extra)
    mine = list(make_data_loader(ours, "test"))
    theirs = list(jax_loader(ref, "test"))
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert a["rays"].shape == (1, 256, 6)
        _assert_batches_equal(a, b)


def test_meta_collation(scene):
    """Batches of two test images: ``meta`` stays a list of dicts, scalars
    become arrays, arrays stack — as the JAX collator does."""
    ours, ref = _both(scene, ["test.batch_size", "2"])
    mine = list(make_data_loader(ours, "test"))
    theirs = list(jax_loader(ref, "test"))
    assert [len(b["meta"]) for b in mine] == [2, 1]
    assert mine[0]["meta"][0] == {"H": 16, "W": 16,
                                  "focal": mine[0]["meta"][0]["focal"]}
    assert mine[0]["i"].tolist() == [0, 1]
    for a, b in zip(mine, theirs):
        _assert_batches_equal(a, b)
    items = [{"x": np.float32(1), "meta": {"a": 1}},
             {"x": np.float32(2), "meta": {"a": 2}}]
    _assert_batches_equal(default_collate(items),
                          __import__("nerf_replication_tpu.datasets.collate",
                                     fromlist=["x"]).default_collate(items))
    assert make_collator(ours, "train") is default_collate


def test_image_size_sampler_tuples(scene):
    """``train.batch_sampler image_size``: the same ``(idx, h, w)`` tuples
    (bucketed sizes drawn from the config seed) over several epochs."""
    extra = ["train.batch_sampler", "image_size", "train.batch_size", "2",
             "train.sampler_meta.min_hw", "[96, 128]",
             "train.sampler_meta.max_hw", "[224, 256]",
             "train.sampler_meta.strides", "32"]
    ours, ref = _both(scene, extra)
    mine = list(make_data_loader(ours, "train", max_iter=9).batch_sampler)
    theirs = list(jax_loader(ref, "train", max_iter=9).batch_sampler)
    assert mine == theirs and len(mine) == 9
    assert all(isinstance(e, tuple) and len(e) == 3 for b in mine for e in b)
    assert len({(b[0][1], b[0][2]) for b in mine}) > 1


@pytest.mark.parametrize("n,world,shuffle", [(5, 2, True), (1, 4, True),
                                             (7, 3, False), (8, 4, True)])
def test_distributed_sampler_slices(n, world, shuffle):
    """Every rank's slice of every epoch equals the JAX sampler's, padded
    by tiling to ``ceil(n / world)`` each."""
    for rank in range(world):
        ours = samplers.DistributedSampler(n, rank, world, seed=3,
                                           shuffle=shuffle)
        ref = jax_samplers.DistributedSampler(n, rank, world, seed=3,
                                              shuffle=shuffle)
        for epoch in range(3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = list(ours)
            assert got == list(ref)
            assert len(got) == len(ours) == -(-n // world)


def test_iteration_based_epochs():
    """``IterationBasedBatchSampler`` re-seeds the random sampler each
    epoch and stops at exactly ``num_iterations``, as the JAX one."""
    def run(mod):
        inner = mod.BatchSampler(mod.RandomSampler(5, seed=11), 2)
        return list(mod.IterationBasedBatchSampler(inner, 8, start_iter=1))

    got = run(samplers)
    assert got == run(jax_samplers)
    assert len(got) == 7
    assert got[:3] != got[3:6]  # the second epoch drew another order
    empty = samplers.IterationBasedBatchSampler(
        samplers.BatchSampler(samplers.SequentialSampler(0), 2), 3)
    with pytest.raises(ValueError, match="no batches"):
        list(empty)


def test_catalog_and_distributed_refusal(scene):
    """The catalog as JAX's; ``is_distributed`` without a process group is
    rank 0 of 1 (JAX's ``process_index()`` / ``process_count()`` on one
    process): the JAX loader's batches, bitwise."""
    assert DatasetCatalog.get("BlenderTest") == JaxCatalog.get("BlenderTest")
    ours, ref = _both(scene)
    mine = make_data_loader(ours, "train", is_distributed=True, max_iter=6)
    theirs = jax_loader(ref, "train", is_distributed=True, max_iter=6)
    assert isinstance(mine.batch_sampler.batch_sampler.sampler,
                      samplers.DistributedSampler)
    assert list(mine.batch_sampler) == list(theirs.batch_sampler)
    np.random.seed(7)  # the train item draws its rays from numpy's RNG
    mine = list(mine)
    np.random.seed(7)
    theirs = list(theirs)
    assert len(mine) == len(theirs) == 6
    for a, b in zip(mine, theirs):
        _assert_batches_equal(a, b)


def test_run_dataset_cli_prints_the_jax_line(scene):
    """``python -m nerf_replication_tpu_torch.run --type dataset`` iterates
    the ported loader (1000 batches) and prints the JAX CLI's line."""
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.run", "--type",
         "dataset", "--cfg_file", LEGO, *_opts(scene)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert re.search(r"^iterated 1000 batches in \d+\.\d\ds "
                     r"\(\d+\.\d it/s\)$", proc.stdout, re.M), proc.stdout
