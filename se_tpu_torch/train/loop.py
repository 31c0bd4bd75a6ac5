"""The training loop (counterpart of ``se_tpu/train/loop.py``; reference:
train_interface.py).

Model and optimiser setup, the loaders, resume or a fresh run directory,
``log.txt``, the epoch loop (checkpoint before validation, per-utterance
PESQ/STOI into ``Epoch_N_SCORES``, ``mse_vali_total.npy``) and the copy of
the best checkpoint.  Batches reach the device through ``prefetch_to_device``;
PESQ/STOI of a validation batch are scored on a host thread while the card
evaluates the next one.  The JAX loop's mesh and multi-host branches are
not ported (ROADMAP.md, Queue 1 item 12).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config
from ..data.dataset import DataLoader, WaveDataset
from ..data.prefetch import prefetch_to_device
from ..device import resolve_device
from ..eval.metrics import cal_pesq, cal_stoi, start_pool
from ..obs import Bar, Writer
from .checkpoint import checkpoint_path, copy_best_checkpoint, restore_checkpoint, save_checkpoint
from .state import create_train_state
from .steps import eval_step, train_step

# validation batches whose scores may be pending at once: each holds its
# batch's waveforms in host memory
MAX_PENDING_SCORES = 4
# batches staged ahead on the device by the prefetch thread
PREFETCH_DEPTH = 2
# epochs between the validation's audio and spectrogram logs (the
# reference's audio cadence, trainer.py:232-233)
MEDIA_EVERY = 10


def score_workers(batch: int) -> int:
    """Processes that score PESQ/STOI: one per CPU core, at most one per
    utterance of a batch, the most scored at once."""
    return min(os.cpu_count() or 1, batch)


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
    asks for ``"cpu"``).  ``score_fn(est, clean) -> (pesq, stoi)`` replaces
    the PESQ/STOI scoring (tests inject fakes).  ``history`` holds one dict
    per epoch run: its losses and mean scores, its steps, and the seconds its
    training (to the last step's end) and its scoring took."""

    def __init__(self, cfg: Config, train_data=None, valid_data=None, score_fn=None,
                 device="cuda"):
        self.cfg = cfg
        self.train_data = train_data if train_data is not None else cfg.train.train_data_path
        self.valid_data = valid_data if valid_data is not None else cfg.train.valid_data_path
        self.score_fn = score_fn
        self.device = device
        self.history = []

    # -- setup -----------------------------------------------------------
    def setup(self):
        cfg = self.cfg
        self.device = resolve_device(self.device)
        if self.score_fn is None:  # the scoring workers start while the model builds and trains
            start_pool(score_workers(cfg.train.batch))
        print(cfg.banner())
        self.model, self.optimizer = create_train_state(cfg, device=self.device)
        self.total_params = sum(p.numel() for p in self.model.parameters())
        print("total params   : %d (%.2f M, %.2f MBytes)\n"
              % (self.total_params, self.total_params / 1e6, self.total_params * 4.0 / 1e6))

        self.train_loader = DataLoader(_as_dataset(self.train_data, "train"), cfg.train.batch,
                                       shuffle=True, drop_last=True, seed=cfg.train.seed)
        self.valid_loader = DataLoader(_as_dataset(self.valid_data, "valid"), cfg.train.batch)

        # resume or a fresh run (reference: train_interface.py:101-138)
        if cfg.train.chkpt_model is not None:
            self.dir_to_save = os.path.join(cfg.train.job_dir, cfg.train.chkpt_model)
            self.dir_to_logs = os.path.join(cfg.train.logs_dir, cfg.train.chkpt_model)
            ckpt_path = checkpoint_path(self.dir_to_save, cfg.train.chkpt)
            print(f"Resuming from checkpoint: {ckpt_path}")
            self.epoch_start_idx = restore_checkpoint(ckpt_path, self.model, self.optimizer) + 1
            # training epoch E draws the loader's epoch E - 1: continue the
            # data order, do not replay epoch 1's
            self.train_loader.set_epoch(self.epoch_start_idx - 1)
            self.mse_vali_total = np.load(os.path.join(self.dir_to_save, "mse_vali_total.npy"))
            if len(self.mse_vali_total) < cfg.train.max_epochs:
                plus = cfg.train.max_epochs - len(self.mse_vali_total)
                self.mse_vali_total = np.concatenate((self.mse_vali_total, np.zeros(plus)), 0)
        else:
            print("Starting new training run...")
            lt = time.localtime()
            run_name = f"{cfg.train.expr_num}_{lt.tm_mon}.{lt.tm_mday}_{cfg.model}_{cfg.loss}"
            self.dir_to_save = os.path.join(cfg.train.job_dir, run_name)
            self.dir_to_logs = os.path.join(cfg.train.logs_dir, run_name)
            self.epoch_start_idx = 1
            self.mse_vali_total = np.zeros(cfg.train.max_epochs)

        os.makedirs(self.dir_to_save, exist_ok=True)
        os.makedirs(self.dir_to_logs, exist_ok=True)
        self.log_fname = os.path.join(self.dir_to_save, "log.txt")
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

    # -- epoch bodies ----------------------------------------------------
    def _feed(self, loader):
        # the bar advances as the step takes a batch, not as the producer
        # thread stages it
        it = prefetch_to_device(iter(loader), depth=PREFETCH_DEPTH, device=self.device)
        return Bar(it, total=len(loader))

    def train_epoch(self) -> dict:
        sums, n = {}, 0
        for noisy, clean in self._feed(self.train_loader):
            metrics = train_step(self.cfg, self.model, self.optimizer, noisy, clean,
                                 self.generator)
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
            fs, workers = self.cfg.stft.fs, score_workers(self.cfg.train.batch)
            scores = (cal_pesq(est, clean, fs, workers=workers),
                      cal_stoi(est, clean, fs, workers=workers))
        return scores, time.perf_counter() - t0

    def validate_epoch(self, epoch: int) -> dict:
        """Loss over the validation set, weighted by each batch's rows, and
        mean PESQ/STOI; each utterance's scores go to ``Epoch_N_SCORES``."""
        cfg = self.cfg
        sums, wsum = {}, 0
        media_epoch = epoch % MEDIA_EVERY == 0
        last = None
        # one scoring thread keeps the batches in order; the scores of a
        # batch fan out over the process pool inside _score
        futures, scored = [], []
        with ThreadPoolExecutor(max_workers=1) as score_pool:
            for noisy, clean in self._feed(self.valid_loader):
                metrics, outputs = eval_step(cfg, self.model, noisy, clean)
                est = outputs.float().cpu().numpy()
                cln = clean.cpu().numpy()
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v.item() * len(est)
                wsum += len(est)
                futures.append(score_pool.submit(self._score, est, cln))
                while len(futures) > MAX_PENDING_SCORES:
                    scored.append(futures.pop(0).result())
                if media_epoch:
                    last = (noisy[0].cpu().numpy(), cln[0], est[0])
            scored.extend(fut.result() for fut in futures)
        if wsum == 0:
            raise ValueError("validation loader yielded no batches: is the validation set empty?")

        pesq_sum = stoi_sum = score_s = 0.0
        with open(os.path.join(self.dir_to_save, f"Epoch_{epoch}_SCORES"), "a") as f_score:
            for (pesq_s, stoi_s), seconds in scored:
                # per-utterance scores (reference: trainer.py:221-222)
                for p, s in zip(pesq_s, stoi_s):
                    f_score.write(f"PESQ {p:.6f} | STOI {s:.6f}\n")
                pesq_sum += float(sum(pesq_s))
                stoi_sum += float(sum(stoi_s))
                score_s += seconds
        if last is not None:
            self.writer.log_wav(*last, epoch)
            self.writer.log_spectrogram(*last, epoch)
        out = {k: v / wsum for k, v in sums.items()}
        out["pesq"] = pesq_sum / wsum
        out["stoi"] = stoi_sum / wsum
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
            save_checkpoint(self.dir_to_save, self.model, self.optimizer, epoch)

            va = self.validate_epoch(epoch)
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

            self.mse_vali_total[epoch - 1] = va["loss"]
            np.save(os.path.join(self.dir_to_save, "mse_vali_total.npy"), self.mse_vali_total)
            self.history.append(dict(
                epoch=epoch, train_loss=tr["loss"], valid_loss=va["loss"], pesq=va["pesq"],
                stoi=va["stoi"], train_seconds=train_s, steps=len(self.train_loader),
                score_seconds=va["score_seconds"]))

        self.fp.close()
        self.writer.close()
        print("Training has been finished.")
        print("Save optimum models...")
        copy_best_checkpoint(self.dir_to_save, self.mse_vali_total)
        print("Minimum validation loss is at "
              + str(int(np.argmin(self.mse_vali_total)) + 1) + ".")
        return self.mse_vali_total


def train(cfg: Config, train_data=None, valid_data=None, score_fn=None,
          device="cuda") -> np.ndarray:
    """Set up a ``Trainer`` and run it -> ``mse_vali_total``."""
    t = Trainer(cfg, train_data, valid_data, score_fn=score_fn, device=device)
    t.setup()
    return t.run()
