"""The PyTorch port's multi-host loader (se_tpu_torch.data.multihost) and its
mesh Trainer in one process, against the JAX package's on the CPU.

Ranks are simulated in process with an explicit rank and world, one
``MultiHostLoader`` each, as ``tests/test_multihost.py`` simulates hosts;
``tests/test_torch_parallel_2proc.py`` runs real ranks."""

import numpy as np
import pytest
import torch

from se_tpu.data import MultiHostLoader as JMultiHostLoader
from se_tpu.data import WaveDataset as JWaveDataset
from se_tpu.data import host_shard as jhost_shard

from se_tpu_torch.config import Config, DccrnConfig, TrainConfig
from se_tpu_torch.data.dataset import MixingDataset, WaveDataset
from se_tpu_torch.data.multihost import MultiHostLoader, host_shard
from se_tpu_torch.parallel.mesh import check_batch
from se_tpu_torch.train.loop import Trainer


def _corpus(n=16, t=800, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2, t)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,count", [(10, 3), (8, 8), (7, 2), (5, 1), (3, 5)])
def test_host_shard_is_the_jax_packages(n, count):
    """Contiguous, ordered, complete and balanced spans, the JAX package's."""
    spans = [host_shard(n, i, count) for i in range(count)]
    assert spans == [jhost_shard(n, i, count) for i in range(count)]
    assert [i for lo, hi in spans for i in range(lo, hi)] == list(range(n))
    with pytest.raises(ValueError):
        host_shard(n, count, count)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_ranks_union_is_the_one_rank_stream_and_jax_hosts(count):
    """Two epochs of every rank's rows, one batch at a time, concatenated in
    rank order: the one-rank stream, and with ``grad_accum=1`` each rank's
    rows are the JAX package's host's (the same (seed, epoch) shuffle)."""
    data = _corpus()
    single = MultiHostLoader(WaveDataset(data), 8, 0, 1, seed=7)
    ranks = [MultiHostLoader(WaveDataset(data), 8, k, count, seed=7) for k in range(count)]
    hosts = [JMultiHostLoader(JWaveDataset(data), 8, process_index=k, process_count=count, seed=7)
             for k in range(count)]
    for _epoch in range(2):
        batches = list(zip(single, *ranks, *hosts))
        assert len(batches) == 2
        for glob, *rest in batches:
            mine, theirs = rest[:count], rest[count:]
            for i in (0, 1):
                np.testing.assert_array_equal(np.concatenate([b[i] for b in mine]), glob[i])
                for a, b in zip(mine, theirs):
                    np.testing.assert_array_equal(a[i], b[i])


def test_micro_batches_interleave_at_grad_accum_2():
    """B=8, A=2 over two ranks: rank r's rows are its 2 of each global
    micro-batch of 4, so its first micro-batch (the first half of its rows)
    is global rows {2r, 2r+1} and its second {4+2r, 5+2r}; JAX's contiguous
    host slice would be rows {4r..4r+3}.  The ranks' k-th micro-batches
    together are the global k-th, in order; the shuffle is the one rank's."""
    data = _corpus()
    single = next(iter(MultiHostLoader(WaveDataset(data), 8, 0, 1, seed=7, grad_accum=2)))
    ranks = [MultiHostLoader(WaveDataset(data), 8, k, 2, seed=7, grad_accum=2) for k in (0, 1)]
    assert [list(r.positions) for r in ranks] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    local = [next(iter(r)) for r in ranks]
    for m in (0, 1):
        got = np.concatenate([rows[0][2 * m : 2 * m + 2] for rows in local])
        np.testing.assert_array_equal(got, single[0][4 * m : 4 * m + 4])


def test_wrap_padded_tail_and_local_valid():
    """11 rows at a global batch of 8 over 4 ranks: one full batch and a tail
    of 3 wrap-padded to 8; every rank's slice keeps the full shape, its
    ``local_valid`` leading rows are real, and their union is rows 8..10 in
    order; a set smaller than one batch still yields one; as the JAX
    package's."""
    data = _corpus(n=11)
    ranks = [MultiHostLoader(WaveDataset(data), 8, k, 4, shuffle=False, drop_last=False)
             for k in range(4)]
    hosts = [JMultiHostLoader(JWaveDataset(data), 8, process_index=k, process_count=4,
                              shuffle=False, drop_last=False) for k in range(4)]
    assert len(ranks[0]) == 2 and ranks[0].valid_per_batch == [8, 3] == hosts[0].valid_per_batch
    assert [r.local_valid(3) for r in ranks] == [h.local_valid(3) for h in hosts] == [2, 1, 0, 0]
    batches = list(zip(*ranks))
    assert all(noisy.shape == (2, 800) for per in batches for noisy, _ in per)
    tail = np.concatenate([noisy[: ranks[k].local_valid(3)]
                           for k, (noisy, _) in enumerate(batches[1])])
    np.testing.assert_array_equal(tail, data[8:11, 0])
    small = [MultiHostLoader(WaveDataset(_corpus(n=3)), 8, k, 4, shuffle=False,
                             drop_last=False) for k in range(4)]
    assert len(small[0]) == 1 and small[0].valid_per_batch == [3]
    assert all(len(list(r)) == 1 for r in small)


def test_mixing_dataset_sees_each_epoch_on_every_rank():
    """On-the-fly mixtures keyed by (seed, epoch, index): every rank's rows
    over two epochs are the one-rank stream's (``set_epoch`` reaches the
    dataset through each rank's loader)."""
    rng = np.random.default_rng(5)
    clean = [rng.standard_normal(800).astype(np.float32) for _ in range(12)]
    noises = [rng.standard_normal(4000).astype(np.float32) for _ in range(3)]

    def make(k, count):
        return MultiHostLoader(MixingDataset(clean, noises, snrs=[0, 5, 10], seed=7), 8, k,
                               count, seed=7)

    single, ranks = make(0, 1), [make(k, 2) for k in (0, 1)]
    for _epoch in range(2):
        for glob, *per in zip(single, *ranks):
            np.testing.assert_array_equal(np.concatenate([p[0] for p in per]), glob[0])


def test_indivisible_batches_raise():
    """A global batch the ranks (or their micro-batches) cannot split raises
    ``ValueError``; the Trainer's check uses the JAX loop's words."""
    with pytest.raises(ValueError, match="not divisible by process_count"):
        MultiHostLoader(WaveDataset(_corpus()), 9, 0, 2)
    with pytest.raises(ValueError, match="grad_accum x process_count"):
        MultiHostLoader(WaveDataset(_corpus()), 6, 0, 2, grad_accum=2)
    with pytest.raises(ValueError, match=r"train.batch=6 must be divisible by grad_accum x mesh "
                                         r"devices \(2 x 2\)"):
        check_batch(6, 2, 2)
    check_batch(8, 2, 2)


def test_trainer_scores_only_real_rows(tmp_path):
    """The mesh Trainer as a group of one (no torchrun environment): its
    validation loader wrap-pads 5 rows to two batches of 4, as the JAX
    loop's one-device mesh does, and scores exactly the 5 real rows, once
    each, in order; the padded rows enter only the loss."""
    rng = np.random.default_rng(0)
    train = (rng.standard_normal((4, 2, 4000)) * 0.05).astype(np.float32)
    valid = (rng.standard_normal((5, 2, 4000)) * 0.05).astype(np.float32)
    cfg = Config(dccrn=DccrnConfig(kernel_num=(8, 16, 16), rnn_units=32),
                 train=TrainConfig(max_epochs=1, batch=4, job_dir=str(tmp_path / "models"),
                                   logs_dir=str(tmp_path / "logs")))
    scored = []

    def fake_score(est, clean):
        scored.append(clean.copy())
        return [float(np.abs(c).mean()) for c in clean], [0.5] * len(est)

    t = Trainer(cfg, train, valid, score_fn=fake_score, device="cpu", use_mesh=True)
    t.setup()
    assert not t.mesh.distributed and t.mesh.world == 1
    assert isinstance(t.valid_loader, MultiHostLoader) and t.valid_loader.valid_per_batch == [4, 1]
    mse = t.run()
    assert np.isfinite(mse[0]) and mse[0] != 0
    np.testing.assert_array_equal(np.concatenate(scored), valid[:, 1])
    lines = (tmp_path / "models" / t.dir_to_save.rsplit("/", 1)[-1] / "Epoch_1_SCORES"
             ).read_text().splitlines()
    assert lines == [f"PESQ {np.abs(c).mean():.6f} | STOI 0.500000" for c in valid[:, 1]]
