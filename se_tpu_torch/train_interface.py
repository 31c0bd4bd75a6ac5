"""Train a DCCRN, CRN or FullSubNet (counterpart of the repository's
``train_interface.py``).

    python -m se_tpu_torch.train_interface --model DCCRN --loss SDR \\
        --train-data data/train.npy --valid-data data/valid.npy [--device cuda]
    python -m se_tpu_torch.train_interface ... --chkpt-model RUN_DIR_NAME --chkpt 1
    python -m se_tpu_torch.train_interface ... --perceptual PMSQE  # or LMS
    python -m se_tpu_torch.train_interface ... --no-skip --use-cbn
    python -m se_tpu_torch.train_interface ... --masking-mode 'Direct(None make)'
    torchrun --nproc_per_node=N -m se_tpu_torch.train_interface ... --mesh

The data are ``[N, 2, T]`` float32 ``.npy`` files, rows (noisy, clean).  A
run writes ``{job-dir}/{expr-num}_{month}.{day}_{model}_{loss}/``: ``log.txt``,
``chkpt_N.pt`` each epoch (the reference's ``{'model', 'optimizer',
'epoch'}`` blob), ``Epoch_N_SCORES`` (each validation utterance's PESQ and
STOI), ``mse_vali_total.npy`` and, at the end, ``chkpt_opt.pt``, the epoch
of least validation loss.  ``--chkpt-model``/``--chkpt`` resume a run from
its directory under ``--job-dir``.  ``--perceptual``, ``--masking-mode``,
``--no-skip`` and ``--use-cbn`` pick the trainer variant and the model as
the JAX CLI's do; a perceptual run's ``log.txt`` gives each epoch's main
and perceptual losses on a second line.  ``--mesh`` trains data-parallel:
under ``torchrun`` (``python -m torch.distributed.run``) one rank a card,
``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``), ``--batch`` the
global batch, which must divide by ``--grad-accum`` x the ranks; without
torchrun's environment a group of one process.  Runs on the card unless
``--device cpu`` is given.  ``--pallas-lstm`` is accepted
for the JAX CLI's command lines and has no effect: on a CUDA tensor the
hand-written kernels always run.
"""

from __future__ import annotations

import argparse

from .config import Config, DccrnConfig, FullSubNetConfig, TrainConfig

# torch and the loop are imported by main(), not here: the scoring pool's
# workers are spawned and each imports this module again, as its main one,
# before it scores with numpy and scipy alone


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="DCCRN", choices=["DCCRN", "CRN", "FullSubNet"])
    p.add_argument("--loss", default="SDR", choices=["MSE", "SDR", "SI-SNR", "SI-SDR"])
    p.add_argument("--perceptual", default="False", choices=["False", "LMS", "PMSQE"])
    p.add_argument("--lstm", default="complex", choices=["real", "complex"])
    p.add_argument("--sequence-model", default="LSTM", choices=["LSTM", "GRU"])
    p.add_argument("--masking-mode", default="E", choices=["Direct(None make)", "E", "C", "R"])
    p.add_argument("--no-skip", action="store_true", help="remove skip connections")
    p.add_argument("--use-cbn", action="store_true", help="complex batch norm in DCCRN")
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-data", required=True, help=".npy of [N, 2, T]")
    p.add_argument("--valid-data", required=True, help=".npy of [N, 2, T]")
    p.add_argument("--job-dir", default="./models/")
    p.add_argument("--logs-dir", default="./logs/")
    p.add_argument("--expr-num", default="EXPERIMENT_NUMBER")
    p.add_argument("--chkpt-model", default=None, help="run dir name to resume")
    p.add_argument("--chkpt", default="EPOCH", help="epoch number to resume from")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over the torchrun group (a group of one without it)")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="activation dtype of the compute path")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="sequential micro-batches per optimiser step")
    p.add_argument("--pallas-lstm", default="auto", choices=["auto", "on", "off"],
                   help="accepted for compatibility; no effect")
    p.add_argument("--fsn-norm", default=None, help="FullSubNet norm_type override")
    p.add_argument("--adam-mu-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="storage dtype of Adam's first moment")
    p.add_argument("--device", default="cuda")
    return p, p.parse_args(argv)


def main(argv=None):
    """Parse ``argv``, train, and return the finished ``Trainer``."""
    from .device import resolve_device
    from .parallel.mesh import destroy
    from .train.loop import Trainer

    p, args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    fsn = FullSubNetConfig(norm_type=args.fsn_norm) if args.fsn_norm else FullSubNetConfig()
    cfg = Config(
        model=args.model,
        loss=args.loss,
        perceptual=False if args.perceptual == "False" else args.perceptual,
        lstm=args.lstm,
        sequence_model=args.sequence_model,
        masking_mode=args.masking_mode,
        skip_type=not args.no_skip,
        dccrn=DccrnConfig(use_cbn=args.use_cbn),
        fullsubnet=fsn,
        compute_dtype=args.compute_dtype,
        train=TrainConfig(
            max_epochs=args.max_epochs,
            learning_rate=args.learning_rate,
            batch=args.batch,
            seed=args.seed,
            grad_accum=args.grad_accum,
            # float32 is Adam's own storage: torch.optim.Adam
            adam_mu_dtype=None if args.adam_mu_dtype == "float32" else args.adam_mu_dtype,
            job_dir=args.job_dir,
            logs_dir=args.logs_dir,
            chkpt_model=args.chkpt_model,
            chkpt=args.chkpt,
            expr_num=args.expr_num,
            train_data_path=args.train_data,
            valid_data_path=args.valid_data,
        ),
    )
    trainer = Trainer(cfg, device=dev, use_mesh=args.mesh)
    try:
        trainer.setup()
        trainer.run()
    finally:
        if getattr(trainer, "mesh", None) is not None:
            destroy(trainer.mesh)
    return trainer


if __name__ == "__main__":
    main()
