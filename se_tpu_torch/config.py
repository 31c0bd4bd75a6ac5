"""Frozen, validated configuration for the PyTorch port.

An own copy of the JAX package's config dataclasses (``se_tpu/config.py``):
the same fields, defaults and validity rules for the model families, the
STFT geometry and training, so a ``Config`` built with the same arguments
in either package describes the same model.  Of the JAX package's
accelerator switches two are copied under their own names:
``use_pallas_conv`` selects the hand-written encoder conv, and
``remat_convs`` recomputes DCCRN's encoder and decoder stages in the
backward (``torch.utils.checkpoint``), trading that recompute for
activation memory on the card as it did on the TPU.  The others (the
Pallas LSTM switch, conv space-to-depth) have no meaning here and are not
copied.  ``ObsConfig`` is copied: its media cadence gates the training
loop's audio and spectrogram logs.  ``ParallelConfig`` is not: a
data-parallel run takes its ranks from torchrun's environment
(``parallel/mesh.py``), not from a config.  ``tutorial_config()`` and
``default_config()`` give the JAX package's two named configurations.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

MODEL_LIST = ("DCCRN", "CRN", "FullSubNet")
LOSS_LIST = ("MSE", "SDR", "SI-SNR", "SI-SDR")
PERCEPTUAL_LIST = (False, "LMS", "PMSQE")
LSTM_TYPES = ("real", "complex")
MAIN_NETS = ("LSTM", "GRU")
MASK_TYPES = ("Direct(None make)", "E", "C", "R")
NORM_TYPES = (
    "offline_laplace_norm",
    "cumulative_laplace_norm",
    "offline_gaussian_norm",
    "cumulative_layer_norm",
)
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class StftConfig:
    """STFT geometry.  ``conv_hop`` is the conv-STFT hop of DCCRN/CRN,
    ``torch_hop`` the framework-STFT hop of FullSubNet (a reference quirk:
    the two paths use different hops)."""

    fs: int = 16000
    win_len: int = 400
    win_inc: int = 100
    ola_ratio: float = 0.75
    fft_len: int = 512
    window: str = "hanning"

    @property
    def num_freqs(self) -> int:
        return self.fft_len // 2 + 1

    @property
    def conv_hop(self) -> int:
        return self.win_inc

    @property
    def torch_hop(self) -> int:
        return int(self.win_len * self.ola_ratio)


@dataclass(frozen=True)
class DccrnConfig:
    rnn_layers: int = 2
    rnn_units: int = 256
    kernel_num: Tuple[int, ...] = (32, 64, 128, 256, 256, 256)
    kernel_size: int = 5
    use_cbn: bool = False


@dataclass(frozen=True)
class CrnConfig:
    rnn_layers: int = 2
    rnn_input_size: int = 512
    rnn_units: int = 256
    kernel_size: int = 5


@dataclass(frozen=True)
class FullSubNetConfig:
    sb_num_neighbors: int = 15
    fb_num_neighbors: int = 0
    look_ahead: int = 2
    fb_output_activate_function: Optional[str] = "ReLU"
    sb_output_activate_function: Optional[str] = None
    fb_model_hidden_size: int = 512
    sb_model_hidden_size: int = 384
    weight_init: bool = False
    norm_type: str = "offline_laplace_norm"
    num_groups_in_drop_band: int = 2
    dropout: float = 0.8


@dataclass(frozen=True)
class TrainConfig:
    max_epochs: int = 100
    learning_rate: float = 1e-3
    batch: int = 10
    seed: int = 0
    grad_accum: int = 1
    adam_mu_dtype: Optional[str] = None
    job_dir: str = "./models/"
    logs_dir: str = "./logs/"
    chkpt_model: Optional[str] = None
    chkpt: str = "EPOCH"
    expr_num: str = "EXPERIMENT_NUMBER"
    train_data_path: Optional[str] = None
    valid_data_path: Optional[str] = None
    test_data_path: Optional[str] = None


@dataclass(frozen=True)
class ObsConfig:
    """Observability.  The reference hard-codes a 10-epoch audio cadence
    (trainer.py:232-233); the training loop logs its validation audio and
    spectrograms on the epochs that ``log_media_every`` divides, none at 0."""

    log_media_every: int = 10


@dataclass(frozen=True)
class Config:
    model: str = "DCCRN"
    loss: str = "SDR"
    perceptual: object = False  # False | 'LMS' | 'PMSQE'
    lstm: str = "complex"
    sequence_model: str = "LSTM"
    masking_mode: str = "E"
    skip_type: bool = True

    stft: StftConfig = field(default_factory=StftConfig)
    dccrn: DccrnConfig = field(default_factory=DccrnConfig)
    crn: CrnConfig = field(default_factory=CrnConfig)
    fullsubnet: FullSubNetConfig = field(default_factory=FullSubNetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    # Activation dtype of the network path; f32 matches the reference.
    compute_dtype: str = "float32"

    # Run DCCRN's encoder convs through the hand-written complex conv
    # kernel K4 (ops/fused_conv.py, csrc/complex_conv.cu) instead of
    # cuDNN's block-form conv.  Off by default, as in the JAX package.
    use_pallas_conv: bool = False

    # Rematerialise DCCRN's whole encoder and decoder stages (conv + BN +
    # PReLU) in the backward pass: only the stages' inputs stay on the card
    # between the forward and the backward.  Off by default, as in the JAX
    # package.
    remat_convs: bool = False

    def __post_init__(self):
        checks = (
            ("model", self.model, MODEL_LIST),
            ("loss", self.loss, LOSS_LIST),
            ("perceptual", self.perceptual, PERCEPTUAL_LIST),
            ("lstm", self.lstm, LSTM_TYPES),
            ("sequence_model", self.sequence_model, MAIN_NETS),
            ("masking_mode", self.masking_mode, MASK_TYPES),
            ("norm_type", self.fullsubnet.norm_type, NORM_TYPES),
            ("compute_dtype", self.compute_dtype, COMPUTE_DTYPES),
        )
        for name, value, allowed in checks:
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
        if self.masking_mode == "Direct(None make)" and self.perceptual is not False:
            raise ValueError("This setting is not created (Direct + perceptual)")
        if self.model == "FullSubNet" and self.perceptual is not False:
            raise ValueError("This setting is not created (FullSubNet + perceptual)")

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def banner(self) -> str:
        """The run's configuration banner, as the JAX package prints it."""
        lines = [
            "--------------------  C  O  N  F  I  G  ----------------------",
            "--------------------------------------------------------------",
            f"MODEL INFO : {self.model}",
            f"LOSS INFO : {self.loss}, perceptual : {self.perceptual}",
        ]
        if self.model != "FullSubNet":
            lines += [
                f"LSTM : {self.lstm}",
                f"SKIP : {self.skip_type}",
                f"MASKING INFO : {self.masking_mode}",
            ]
        else:
            lines += [f"Main network : {self.sequence_model}"]
        lines += [
            f"\nBATCH : {self.train.batch}",
            f"LEARNING RATE : {self.train.learning_rate}",
            "--------------------------------------------------------------",
            "--------------------------------------------------------------\n",
        ]
        return "\n".join(lines)


def tutorial_config() -> Config:
    """The tutorial's configuration (the reference's SE_tutorials.ipynb):
    CRN, E mask, MSE, the real LSTM."""
    return Config(model="CRN", loss="MSE", lstm="real", masking_mode="E")


def default_config() -> Config:
    return Config()
