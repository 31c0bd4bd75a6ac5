"""The training loop (counterpart of ``se_tpu/train/loop.py``; reference:
train_interface.py).

Model and optimiser setup, the loaders, resume or a fresh run directory,
``log.txt``, the epoch loop (checkpoint before validation, per-utterance
PESQ/STOI into ``Epoch_N_SCORES``, ``mse_vali_total.npy``) and the copy of
the best checkpoint.  Batches reach the device through ``prefetch_to_device``;
PESQ/STOI of a validation batch are scored on a host thread while the card
evaluates the next one.

With ``use_mesh`` (the CLI's ``--mesh``) the run is data-parallel over the
``torch.distributed`` group of ``parallel/mesh.py``, one rank a card, as the
JAX loop's mesh branch: both loaders are ``MultiHostLoader``s, the
validation tail wrap-padded to a full global batch even in a group of one;
each rank steps with ``parallel/dp.py`` and scores its real rows, and rank 0
writes the run directory (``log.txt``, the checkpoints,
``mse_vali_total.npy``, ``Epoch_N_SCORES`` from every rank's rows in global
order, the writer's logs).  Every rank resumes from the same checkpoint.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config
from ..data.dataset import DataLoader, WaveDataset
from ..data.multihost import MultiHostLoader
from ..data.prefetch import prefetch_to_device
from ..device import resolve_device
from ..eval.metrics import cal_pesq, cal_stoi, start_pool
from ..obs import Bar, Writer
from ..parallel import mesh as mesh_lib
from ..parallel.dp import parallel_eval_step, parallel_train_step
from .checkpoint import checkpoint_path, copy_best_checkpoint, restore_checkpoint, save_checkpoint
from .state import create_train_state
from .steps import eval_step, train_step

# validation batches whose scores may be pending at once: each holds its
# batch's waveforms in host memory
MAX_PENDING_SCORES = 4
# batches staged ahead on the device by the prefetch thread
PREFETCH_DEPTH = 2


def score_workers(batch: int, local_world: int = 1) -> int:
    """Processes that score PESQ/STOI: one per CPU core of this rank's share
    of the host (``local_world`` ranks on it), at most one per utterance of
    its ``batch`` rows, the most scored at once."""
    return max(1, min((os.cpu_count() or 1) // local_world, batch))


def _result(future):
    """A scoring future's ``((pesq, stoi), seconds)``; no scores for None."""
    return (([], []), 0.0) if future is None else future.result()


def _as_dataset(d, mode: str):
    """Paths and ``[N, 2, T]`` arrays become a ``WaveDataset``; any other
    object with ``__len__`` and ``__getitem__`` is used as it is."""
    if isinstance(d, (str, np.ndarray)):
        return WaveDataset(d, mode)
    return d


def write_status_to_log_file(fp, total_parameters: int):
    """reference: train_interface.py:21-29."""
    lt = time.localtime()
    fp.write("%d-%d-%d %d:%d:%d\n"
             % (lt.tm_year, lt.tm_mon, lt.tm_mday, lt.tm_hour, lt.tm_min, lt.tm_sec))
    fp.write("total params   : %d (%.2f M, %.2f MBytes)\n"
             % (total_parameters, total_parameters / 1000000.0, total_parameters * 4.0 / 1000000.0))


class Trainer:
    """One training run of ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``; under ``use_mesh``, ``cuda`` is ``cuda:LOCAL_RANK``).
    ``score_fn(est, clean) -> (pesq, stoi)`` replaces the PESQ/STOI scoring
    (tests inject fakes).  ``history`` holds one dict per epoch run: its
    losses and mean scores, its steps, and the seconds its training (to the
    last step's end) and its scoring took."""

    def __init__(self, cfg: Config, train_data=None, valid_data=None, score_fn=None,
                 device="cuda", use_mesh: bool = False):
        self.cfg = cfg
        self.train_data = train_data if train_data is not None else cfg.train.train_data_path
        self.valid_data = valid_data if valid_data is not None else cfg.train.valid_data_path
        self.score_fn = score_fn
        self.device = device
        self.use_mesh = use_mesh
        self.history = []

    # -- setup -----------------------------------------------------------
    def setup(self):
        cfg = self.cfg
        if self.use_mesh:
            self.mesh = mesh_lib.make_mesh(self.device)
            self.device = self.mesh.device
            mesh_lib.check_batch(cfg.train.batch, cfg.train.grad_accum, self.mesh.world)
        else:
            self.mesh = None
            self.device = resolve_device(self.device)
        # rank 0 writes the run directory and the logs
        self.is_main = self.mesh is None or self.mesh.is_main
        world = 1 if self.mesh is None else self.mesh.world
        self.local_batch = cfg.train.batch // world
        if self.score_fn is None:  # the scoring workers start while the model builds and trains
            start_pool(self._score_workers())
        self._print(cfg.banner())
        if self.mesh is not None:
            self._print(self.mesh.banner())
        self.model, self.optimizer = create_train_state(cfg, device=self.device)
        if self.mesh is not None:
            mesh_lib.broadcast_state(self.mesh, self.model)
        self.total_params = sum(p.numel() for p in self.model.parameters())
        self._print("total params   : %d (%.2f M, %.2f MBytes)\n"
                    % (self.total_params, self.total_params / 1e6, self.total_params * 4.0 / 1e6))

        train_ds = _as_dataset(self.train_data, "train")
        valid_ds = _as_dataset(self.valid_data, "valid")
        if self.mesh is not None:
            self.train_loader = MultiHostLoader(
                train_ds, cfg.train.batch, self.mesh.rank, world, shuffle=True,
                seed=cfg.train.seed, drop_last=True, grad_accum=cfg.train.grad_accum)
            self.valid_loader = MultiHostLoader(valid_ds, cfg.train.batch, self.mesh.rank, world,
                                                shuffle=False, drop_last=False)
        else:
            self.train_loader = DataLoader(train_ds, cfg.train.batch, shuffle=True,
                                           drop_last=True, seed=cfg.train.seed)
            self.valid_loader = DataLoader(valid_ds, cfg.train.batch)

        # resume or a fresh run (reference: train_interface.py:101-138)
        if cfg.train.chkpt_model is not None:
            self.dir_to_save = os.path.join(cfg.train.job_dir, cfg.train.chkpt_model)
            self.dir_to_logs = os.path.join(cfg.train.logs_dir, cfg.train.chkpt_model)
            ckpt_path = checkpoint_path(self.dir_to_save, cfg.train.chkpt)
            self._print(f"Resuming from checkpoint: {ckpt_path}")
            self.epoch_start_idx = restore_checkpoint(ckpt_path, self.model, self.optimizer) + 1
            # training epoch E draws the loader's epoch E - 1: continue the
            # data order, do not replay epoch 1's
            self.train_loader.set_epoch(self.epoch_start_idx - 1)
            self.mse_vali_total = np.load(os.path.join(self.dir_to_save, "mse_vali_total.npy"))
            if len(self.mse_vali_total) < cfg.train.max_epochs:
                plus = cfg.train.max_epochs - len(self.mse_vali_total)
                self.mse_vali_total = np.concatenate((self.mse_vali_total, np.zeros(plus)), 0)
        else:
            self._print("Starting new training run...")
            lt = time.localtime()
            run_name = f"{cfg.train.expr_num}_{lt.tm_mon}.{lt.tm_mday}_{cfg.model}_{cfg.loss}"
            self.dir_to_save = os.path.join(cfg.train.job_dir, run_name)
            self.dir_to_logs = os.path.join(cfg.train.logs_dir, run_name)
            self.epoch_start_idx = 1
            self.mse_vali_total = np.zeros(cfg.train.max_epochs)

        self.log_fname = os.path.join(self.dir_to_save, "log.txt")
        self.fp = self.writer = None
        if self.is_main:
            os.makedirs(self.dir_to_save, exist_ok=True)
            os.makedirs(self.dir_to_logs, exist_ok=True)
            new_log = not os.path.exists(self.log_fname)
            self.fp = open(self.log_fname, "w" if new_log else "a")
            if new_log:
                write_status_to_log_file(self.fp, self.total_params)
            self.writer = Writer(self.dir_to_logs, fs=cfg.stft.fs, n_fft=cfg.stft.fft_len,
                                 n_overlap=cfg.stft.win_inc)
        # FullSubNet's dropout masks: a generator on the model's device, seeded
        # from cfg.train.seed at every start, a resume included, as the JAX
        # loop seeds its dropout key
        self.generator = None
        if cfg.model == "FullSubNet":
            self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg)

    def _score_workers(self) -> int:
        local_world = 1 if self.mesh is None else self.mesh.local_world
        return score_workers(self.local_batch, local_world)

    # -- epoch bodies ----------------------------------------------------
    def _feed(self, loader):
        # the bar advances as the step takes a batch, not as the producer
        # thread stages it
        it = prefetch_to_device(iter(loader), depth=PREFETCH_DEPTH, device=self.device)
        return Bar(it, total=len(loader)) if self.is_main else it

    def train_epoch(self) -> dict:
        sums, n = {}, 0
        for noisy, clean in self._feed(self.train_loader):
            if self.mesh is None:
                metrics = train_step(self.cfg, self.model, self.optimizer, noisy, clean,
                                     self.generator)
            else:
                metrics = parallel_train_step(self.cfg, self.model, self.optimizer, self.mesh,
                                              noisy, clean, self.generator)
            n += 1
            # summed on the device: reading each step's loss would wait for it
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.double()
        if n == 0:
            raise ValueError(
                f"train loader yielded no batches: the training set "
                f"({len(self.train_loader.dataset)} rows) is smaller than one batch "
                f"({self.cfg.train.batch}) with drop_last")
        return {k: v.item() / n for k, v in sums.items()}

    def _score(self, est: np.ndarray, clean: np.ndarray):
        """``(pesq, stoi)`` of a batch on the host, and the seconds taken."""
        t0 = time.perf_counter()
        if self.score_fn is not None:
            scores = self.score_fn(est, clean)
        else:
            fs, workers = self.cfg.stft.fs, self._score_workers()
            scores = (cal_pesq(est, clean, fs, workers=workers),
                      cal_stoi(est, clean, fs, workers=workers))
        return scores, time.perf_counter() - t0

    def validate_epoch(self, epoch: int) -> dict:
        """Loss over the validation set, weighted by each batch's real rows,
        and mean PESQ/STOI of the real rows; each utterance's scores go to
        ``Epoch_N_SCORES`` in the set's order.  Under the mesh each rank
        scores its real rows (the wrap-padded ones enter only the loss, as
        in the JAX loop) and the scores of every rank are gathered."""
        cfg = self.cfg
        sums, wsum = {}, 0
        # the validation's audio and spectrograms, on ObsConfig's cadence
        every = cfg.obs.log_media_every
        media_epoch = every > 0 and epoch % every == 0
        last = None
        # global real rows per batch where the loader wrap-pads its tail
        counts = getattr(self.valid_loader, "valid_per_batch", None)
        # one scoring thread keeps the batches in order; the scores of a
        # batch fan out over the process pool inside _score
        futures, scored = [], []
        with ThreadPoolExecutor(max_workers=1) as score_pool:
            for bi, (noisy, clean) in enumerate(self._feed(self.valid_loader)):
                if self.mesh is None:
                    metrics, outputs = eval_step(cfg, self.model, noisy, clean)
                else:
                    metrics, outputs = parallel_eval_step(cfg, self.model, self.mesh, noisy,
                                                          clean)
                est = outputs.float().cpu().numpy()
                cln = clean.cpu().numpy()
                g_valid = len(est) if counts is None else counts[bi]
                if counts is not None:
                    l_valid = self.valid_loader.local_valid(g_valid)
                    est, cln = est[:l_valid], cln[:l_valid]
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v.item() * g_valid
                wsum += g_valid
                # a rank whose rows of the tail are all padding scores none
                futures.append(score_pool.submit(self._score, est, cln) if len(est) else None)
                while len(futures) > MAX_PENDING_SCORES:
                    scored.append(_result(futures.pop(0)))
                if media_epoch and len(est):
                    last = (noisy[0].cpu().numpy(), cln[0], est[0])
            scored.extend(_result(fut) for fut in futures)
        if wsum == 0:
            raise ValueError("validation loader yielded no batches: is the validation set empty?")

        # each batch's scores, rank after rank: the set's order
        ranks = [scored] if self.mesh is None else mesh_lib.all_gather_object(self.mesh, scored)
        batches = [scores for batch in zip(*ranks) for scores, _ in batch]
        rows = [row for pesq_s, stoi_s in batches for row in zip(pesq_s, stoi_s)]
        score_s = sum(seconds for _, seconds in scored)
        if self.is_main:
            with open(os.path.join(self.dir_to_save, f"Epoch_{epoch}_SCORES"), "a") as f_score:
                # per-utterance scores (reference: trainer.py:221-222)
                for p, s in rows:
                    f_score.write(f"PESQ {p:.6f} | STOI {s:.6f}\n")
            if last is not None:
                self.writer.log_wav(*last, epoch)
                self.writer.log_spectrogram(*last, epoch)
        out = {k: v / wsum for k, v in sums.items()}
        out["pesq"] = sum(float(sum(pesq_s)) for pesq_s, _ in batches) / max(len(rows), 1)
        out["stoi"] = sum(float(sum(stoi_s)) for _, stoi_s in batches) / max(len(rows), 1)
        out["score_seconds"] = score_s
        return out

    # -- full run --------------------------------------------------------
    def run(self) -> np.ndarray:
        cfg = self.cfg
        perceptual = cfg.perceptual is not False
        for epoch in range(self.epoch_start_idx, cfg.train.max_epochs + 1):
            start_time = time.time()
            tr = self.train_epoch()
            train_s = time.time() - start_time

            # checkpoint BEFORE validation (reference: train_interface.py:205)
            if self.is_main:
                save_checkpoint(self.dir_to_save, self.model, self.optimizer, epoch)

            va = self.validate_epoch(epoch)
            self.mse_vali_total[epoch - 1] = va["loss"]
            self.history.append(dict(
                epoch=epoch, train_loss=tr["loss"], valid_loss=va["loss"], pesq=va["pesq"],
                stoi=va["stoi"], train_seconds=train_s, steps=len(self.train_loader),
                score_seconds=va["score_seconds"]))
            if not self.is_main:
                continue
            self.writer.log_loss(tr["loss"], va["loss"], epoch)
            self.writer.log_score(va["pesq"], va["stoi"], epoch)
            if perceptual:
                self.writer.log_sub_loss(tr["main_loss"], tr["perceptual_loss"],
                                         va["main_loss"], va["perceptual_loss"], epoch)
                msg = (f"Epoch [{epoch}] | T {tr['loss']:.6f} | V {va['loss']:.6}\n"
                       f"          | T {tr['main_loss']:.6f} {tr['perceptual_loss']:.6f} "
                       f"| V {va['main_loss']:.6} {va['perceptual_loss']:.6f} takes "
                       f"{time.time() - start_time:.2f} seconds\n")
            else:
                msg = (f"Epoch [{epoch}] | T {tr['loss']:.6f} | V {va['loss']:.6} "
                       f"takes {time.time() - start_time:.2f} seconds\n")
            msg += f"          | V PESQ: {va['pesq']:.6f} | STOI: {va['stoi']:.6f} \n"
            print(msg)
            self.fp.write(msg)
            self.fp.flush()
            np.save(os.path.join(self.dir_to_save, "mse_vali_total.npy"), self.mse_vali_total)

        if self.is_main:
            self.fp.close()
            self.writer.close()
            print("Training has been finished.")
            print("Save optimum models...")
            copy_best_checkpoint(self.dir_to_save, self.mse_vali_total)
            print("Minimum validation loss is at "
                  + str(int(np.argmin(self.mse_vali_total)) + 1) + ".")
        if self.mesh is not None:
            # the other ranks return once the run directory is whole
            mesh_lib.barrier(self.mesh)
        return self.mse_vali_total


def train(cfg: Config, train_data=None, valid_data=None, score_fn=None,
          device="cuda", use_mesh: bool = False) -> np.ndarray:
    """Set up a ``Trainer`` and run it -> ``mse_vali_total``."""
    t = Trainer(cfg, train_data, valid_data, score_fn=score_fn, device=device,
                use_mesh=use_mesh)
    t.setup()
    return t.run()
