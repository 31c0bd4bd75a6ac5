"""FullSubNet: full-band / sub-band fusion predicting a compressed cIRM
(counterpart of ``se_tpu/models/fullsubnet.py``).

Noisy magnitudes ``[B, F, T]`` -> ``look_ahead`` zero frames appended ->
norm -> the full-band ``SequenceModel`` (``fb_model``, F -> F) -> each
bin's neighbourhood of the full-band output and of the noisy magnitudes
(``unfold``) -> norm -> the sub-band ``SequenceModel`` (``sb_model``) over a
batch of ``B * F`` sequences -> the first ``look_ahead`` frames dropped ->
``[B, F, T, 2]``.  Module names follow the reference's state-dict grammar
(``fb_model.sequence_model.weight_ih_l0``, ``sb_model.fc_output_layer.*``).

Under ``compute_dtype="bfloat16"`` the magnitudes are cast to bf16 before
the look-ahead pad and the network runs on bf16 activations, as the
reference's (``se_tpu/models/fullsubnet.py:87-91``): the norms take their
statistics in f32 and divide in bf16, the sequence models run their RNNs'
bf16-stream forms around f32 carries, the linear maps cast their f32
weights to bf16, and the cRM is cast back to f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..ops.norms import norm_wrapper
from ..ops.unfold import unfold
from .layers import SequenceModel


class FullSubNet(nn.Module):
    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        fsn = cfg.fullsubnet
        self.cfg = cfg
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        num_freqs = cfg.stft.num_freqs
        self.fb_model = SequenceModel(
            num_freqs, num_freqs, fsn.fb_model_hidden_size, 2, cfg.sequence_model,
            fsn.fb_output_activate_function, fsn.dropout, generator=generator,
        )
        self.sb_model = SequenceModel(
            (fsn.sb_num_neighbors * 2 + 1) + (fsn.fb_num_neighbors * 2 + 1), 2,
            fsn.sb_model_hidden_size, 2, cfg.sequence_model,
            fsn.sb_output_activate_function, fsn.dropout, generator=generator,
        )
        self.sb_num_neighbors = fsn.sb_num_neighbors
        self.fb_num_neighbors = fsn.fb_num_neighbors
        self.look_ahead = fsn.look_ahead
        self.norm = norm_wrapper(fsn.norm_type)

    def forward(self, noisy_mag: torch.Tensor, valid_frames=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, F, T]`` (or ``[B, 1, F, T]``) noisy magnitudes -> ``[B, F, T,
        2]`` cRM.

        ``valid_frames`` (a scalar or one count per sample): the input is a
        padded buffer whose first ``valid_frames`` frames are real; later
        frames are zeroed and the offline norms take their statistics over
        ``valid_frames + look_ahead`` frames, as the exact-length run counts
        its ``look_ahead`` zero frames, so the valid prefix matches that run.
        Outputs at and after a sample's count are for the caller to crop.
        ``generator`` draws the dropout masks in train mode.
        """
        if noisy_mag.ndim == 3:
            noisy_mag = noisy_mag[:, None]
        stat_frames = None
        if valid_frames is not None:
            vf = torch.as_tensor(valid_frames, device=noisy_mag.device).reshape(-1, 1, 1, 1)
            frames = torch.arange(noisy_mag.shape[-1], device=noisy_mag.device)
            noisy_mag = noisy_mag * (frames < vf).to(noisy_mag.dtype)
            stat_frames = vf + self.look_ahead
        noisy_mag = F.pad(noisy_mag.to(self.compute_dtype), (0, self.look_ahead))
        B, C, Fq, T = noisy_mag.shape
        if C != 1:
            raise ValueError(f"{type(self).__name__} takes the mag feature as inputs.")

        fb_input = self.norm(noisy_mag, valid_frames=stat_frames).reshape(B, C * Fq, T)
        fb_output = self.fb_model(fb_input, generator).reshape(B, 1, Fq, T)

        # neighbourhoods of the full-band output and of the noisy magnitudes
        n_fb, n_sb = self.fb_num_neighbors * 2 + 1, self.sb_num_neighbors * 2 + 1
        fb_unfolded = unfold(fb_output, self.fb_num_neighbors).reshape(B, Fq, n_fb, T)
        noisy_unfolded = unfold(noisy_mag, self.sb_num_neighbors).reshape(B, Fq, n_sb, T)

        sb_input = torch.cat([noisy_unfolded, fb_unfolded], dim=2)
        sb_input = self.norm(sb_input, valid_frames=stat_frames)
        sb_input = sb_input.reshape(B * Fq, n_sb + n_fb, T)

        # [B * F, n_sb + n_fb, T] -> [B * F, 2, T] -> [B, 2, F, T]
        sb_mask = self.sb_model(sb_input, generator).reshape(B, Fq, 2, T).permute(0, 2, 1, 3)
        output = sb_mask[:, :, :, self.look_ahead :]
        return output.permute(0, 2, 3, 1).float()  # [B, F, T, 2]
