"""CRN: real-valued magnitude-domain convolutional recurrent network
(counterpart of ``se_tpu/models/crn.py``).

Conv-STFT magnitude -> real conv encoder -> one-layer LSTM bottleneck and a
linear map back to the encoder's width -> real transposed-conv decoder with
skip connections, or none (``skip_type=False``) -> a tanh mask on the noisy
magnitude (E, C and R masks alike) or the magnitude itself (``"Direct(None
make)"``) -> noisy phase -> conv-iSTFT -> clip to +-1.  Under
``compute_dtype="bfloat16"`` the network from the magnitudes to the
decoder's output runs in bf16 (the LSTM on bf16 streams around an f32
carry), the STFT, the mask and the iSTFT in f32.  Module names follow the
reference's state-dict grammar (``encoder.{i}.0.conv.*``,
``enhance.weight_ih_l0``, ``tranform.*``, ``decoder.{i}.0.conv.*``; without
skip connections the reference's decoder convs are bare,
``decoder.{i}.0.*``).  The no-skip decoder takes the channels that reach
it, ``kernel_num[idx] // 2``, as the JAX package's does: the reference
declares ``kernel_num[idx]`` and cannot run that variant.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..ops.magnitude import complex_mag
from .dccrn import ConviSTFT, ConvSTFT
from .layers import (
    ConvTranspose2d,
    PReLU,
    RealConv2d,
    RealConvTranspose2d,
    TorchBatchNorm2d,
    TorchLinear,
    TorchLSTM,
)


class CRN(nn.Module):
    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        c = cfg
        self.skip = c.skip_type
        self.compute_dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        self.direct = c.masking_mode == "Direct(None make)"
        self.fft_len = c.stft.fft_len
        s = c.stft
        self.stft = ConvSTFT(s.win_len, s.win_inc, s.fft_len, s.window)
        self.istft = ConviSTFT(s.win_len, s.win_inc, s.fft_len, s.window)

        kernel_num = (2,) + tuple(c.dccrn.kernel_num)
        ks = c.crn.kernel_size
        n_stage = len(kernel_num) - 1
        self.encoder = nn.ModuleList(
            nn.Sequential(
                RealConv2d(kernel_num[i] // 2, kernel_num[i + 1] // 2, kernel_size=(ks, 2),
                           stride=(2, 1), padding=(2, 1), generator=generator),
                TorchBatchNorm2d(kernel_num[i + 1] // 2),
                PReLU(),
            )
            for i in range(n_stage)
        )
        # One layer, whatever CrnConfig.rnn_layers says: the reference
        # builds num_layers=1 and never reads that field.
        self.enhance = TorchLSTM(c.crn.rnn_input_size, c.crn.rnn_units // 2, num_layers=1,
                                 generator=generator)
        self.tranform = TorchLinear(c.crn.rnn_units // 2, c.crn.rnn_input_size,
                                    generator=generator)

        decoder = []
        conv_t = RealConvTranspose2d if self.skip else ConvTranspose2d
        for idx in range(n_stage, 0, -1):
            in_ch = kernel_num[idx] if self.skip else kernel_num[idx] // 2
            stage = [
                conv_t(
                    in_ch, kernel_num[idx - 1] // 2, kernel_size=(ks, 2),
                    stride=(2, 1), padding=(2, 0), output_padding=(1, 0),
                    generator=generator,
                )
            ]
            if idx != 1:  # the last stage has no BN or PReLU
                stage += [TorchBatchNorm2d(kernel_num[idx - 1] // 2), PReLU()]
            decoder.append(nn.Sequential(*stage))
        self.decoder = nn.ModuleList(decoder)

    def _mag_phase(self, x):
        specs = self.stft(x)  # [B, fft_len + 2, T]
        dim = self.fft_len // 2 + 1
        real, imag = specs[:, :dim], specs[:, dim:]
        return complex_mag(real, imag), torch.atan2(imag, real)

    def forward(self, inputs, targets: Optional[torch.Tensor] = None):
        """``inputs [B, L]`` (and optionally ``targets [B, L]``) ->
        ``(est_mags, target_mags, out_wav)`` with a mask, or ``(out_mags,
        target_mags, out_wav)`` in direct mode; ``target_mags`` is None when
        no targets are given."""
        mags, phase = self._mag_phase(inputs)
        out = mags[:, None, 1:].to(self.compute_dtype)  # drop the DC bin
        encoder_out = []
        for stage in self.encoder:
            out = stage(out)
            encoder_out.append(out)

        B, C, D, T = out.shape
        out = out.permute(3, 0, 1, 2).reshape(T, B, C * D)
        out = self.tranform(self.enhance(out))
        out = out.reshape(T, B, C, D).permute(1, 2, 3, 0)  # [B, C, D, T]

        for idx, stage in enumerate(self.decoder):
            if self.skip:
                out = torch.cat([out, encoder_out[-1 - idx]], 1)
            out = stage(out)[..., 1:]  # causal time trim per stage
        out = F.pad(out[:, 0].float(), (0, 0, 1, 0))  # re-pad the DC bin

        target_mags = None if targets is None else self._mag_phase(targets)[0]
        est_mags = out if self.direct else torch.tanh(out) * mags
        spec = torch.cat([est_mags * torch.cos(phase), est_mags * torch.sin(phase)], dim=1)
        out_wav = self.istft(spec)[:, 0]
        return est_mags, target_mags, torch.clamp(out_wav, -1.0, 1.0)
