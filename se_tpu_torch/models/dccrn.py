"""DCCRN: deep complex convolution recurrent network (counterpart of
``se_tpu/models/dccrn.py``).

Conv-STFT -> complex conv encoder -> complex LSTM bottleneck -> complex
transposed-conv decoder with skip connections -> mask on the noisy
spectrum -> conv-iSTFT -> clip to +-1.  Variants: the complex LSTM or the
real one (``lstm="real"``: a two-layer ``nn.LSTM`` over the real and
imaginary channels together, then a linear map back); skip connections or
none (``skip_type=False``); real BatchNorm or the complex whitening one
(``dccrn.use_cbn``); the E, C and R masks, or direct mapping
(``"Direct(None make)"``: the decoder's output is the spectrum, and the
forward also returns the targets' spectrum); ``use_pallas_conv``: the
encoder convs through the hand-written kernel K4 (``ops/fused_conv.py``);
and ``compute_dtype="bfloat16"``: the reference's mixed precision
(parameters f32, each op casting them to its activation dtype), with the
STFT, the mask, the iSTFT and the real LSTM in f32 and the complex LSTM on
bf16 streams around an f32 carry; ``remat_convs``: in a train-mode forward
with gradients, each encoder and decoder stage is recomputed from its input
in the backward (``layers.remat``), its BatchNorm's running statistics
updated once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import Config
from ..dsp.stft import conv_stft_bases, conv_istft, conv_stft
from ..ops.magnitude import complex_mag, safe_arctan2
from .layers import (
    ComplexBatchNorm,
    ComplexConv2d,
    ComplexConvTranspose2d,
    NavieComplexLSTM,
    PReLU,
    TorchBatchNorm2d,
    TorchLinear,
    TorchLSTM,
    complex_cat,
    remat,
)


class ConvSTFT(nn.Module):
    """Holds the analysis basis as the reference's ``stft.weight`` buffer,
    ``[fft_len + 2, 1, win_len]``."""

    def __init__(self, win_len: int, hop: int, fft_len: int, window: str):
        super().__init__()
        fwd, _, _ = conv_stft_bases(win_len, fft_len, window)
        self.win_len, self.hop = win_len, hop
        self.register_buffer("weight", torch.from_numpy(fwd.T.copy())[:, None, :])

    def forward(self, x):
        return conv_stft(x, self.weight[:, 0, :].T, self.win_len, self.hop)


class ConviSTFT(nn.Module):
    """Holds the synthesis basis, the window and the identity ``enframe``
    kernel as the reference's ``istft.*`` buffers.  ``enframe`` is kept for
    loading only: the overlap-add needs no kernel."""

    def __init__(self, win_len: int, hop: int, fft_len: int, window: str):
        super().__init__()
        _, inv, win = conv_stft_bases(win_len, fft_len, window)
        self.hop = hop
        self.register_buffer("weight", torch.from_numpy(inv.T.copy())[:, None, :])
        self.register_buffer("window", torch.from_numpy(win)[None, :, None])
        self.register_buffer("enframe", torch.eye(win_len)[:, None, :])

    def forward(self, spec):
        return conv_istft(spec, self.weight[:, 0, :].T, self.window[0, :, 0], self.hop)


class DCCRN(nn.Module):
    def __init__(self, cfg: Config, *, generator: torch.Generator):
        super().__init__()
        c = cfg
        self.compute_dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else torch.float32
        self.masking_mode = c.masking_mode
        self.skip = c.skip_type
        self.remat = c.remat_convs
        self.real_lstm = c.lstm == "real"
        self.fft_len = c.stft.fft_len
        s = c.stft
        self.stft = ConvSTFT(s.win_len, s.win_inc, s.fft_len, s.window)
        self.istft = ConviSTFT(s.win_len, s.win_inc, s.fft_len, s.window)

        kernel_num = (2,) + tuple(c.dccrn.kernel_num)
        ks = c.dccrn.kernel_size
        n_stage = len(kernel_num) - 1

        def norm(n):
            return (ComplexBatchNorm(n, generator=generator) if c.dccrn.use_cbn
                    else TorchBatchNorm2d(n))

        self.encoder = nn.ModuleList(
            nn.Sequential(
                ComplexConv2d(kernel_num[i], kernel_num[i + 1], kernel_size=(ks, 2),
                              stride=(2, 1), padding=(2, 1), use_pallas=c.use_pallas_conv,
                              generator=generator),
                norm(kernel_num[i + 1]),
                PReLU(),
            )
            for i in range(n_stage)
        )

        hidden_dim = self.fft_len // (2 ** len(kernel_num))
        units, layers = c.dccrn.rnn_units, c.dccrn.rnn_layers
        width = hidden_dim * kernel_num[-1]
        if self.real_lstm:
            # two layers whatever rnn_layers says, as the reference builds it
            self.enhance = TorchLSTM(width, units, num_layers=2, generator=generator)
            self.tranform = TorchLinear(units, width, generator=generator)
        else:
            self.enhance = nn.ModuleList(
                NavieComplexLSTM(
                    input_size=width if idx == 0 else units,
                    hidden_size=units,
                    projection_dim=width if idx == layers - 1 else None,
                    generator=generator,
                )
                for idx in range(layers)
            )

        decoder = []
        skip_mult = 2 if self.skip else 1
        for idx in range(n_stage, 0, -1):
            stage = [
                ComplexConvTranspose2d(
                    kernel_num[idx] * skip_mult, kernel_num[idx - 1], kernel_size=(ks, 2),
                    stride=(2, 1), padding=(2, 0), output_padding=(1, 0),
                    generator=generator,
                )
            ]
            if idx != 1:  # the last stage has no BN or PReLU
                stage += [norm(kernel_num[idx - 1]), PReLU()]
            decoder.append(nn.Sequential(*stage))
        self.decoder = nn.ModuleList(decoder)

    def forward(self, inputs, targets: Optional[torch.Tensor] = None):
        """``inputs [B, L]`` -> ``(out_real, out_imag, out_wav)`` with a mask;
        in direct mode, ``(out_real, target_real, out_imag, target_imag,
        out_wav)``, the targets' spectrum from the model's own STFT of
        ``targets [B, L]``, which direct mode needs.  Other modes ignore
        ``targets``."""
        direct = self.masking_mode == "Direct(None make)"
        if direct and targets is None:
            raise ValueError(
                "a DCCRN with masking_mode 'Direct(None make)' maps to the spectrum and returns "
                "it beside the targets' spectrum: it needs targets, so it cannot enhance alone"
            )
        specs = self.stft(inputs)  # [B, fft_len + 2, T]
        dim = self.fft_len // 2 + 1
        real, imag = specs[:, :dim], specs[:, dim:]
        # drop the DC bin; the network runs in the compute dtype from here
        out = torch.stack([real, imag], dim=1)[:, :, 1:].to(self.compute_dtype)

        # remat_convs: each stage (conv + BN + PReLU) recomputed from its input
        # in the backward (se_tpu/models/dccrn.py:199-210, :252).  Under
        # --mesh the recompute runs the global BatchNorm's all-reduces
        # (ops/shard.py) again; every rank recomputes the same stages in the
        # same order, so the collectives stay matched
        stage_remat = self.remat and self.training and torch.is_grad_enabled()
        run = remat if stage_remat else (lambda fn, x: fn(x))
        encoder_out = []
        for stage in self.encoder:
            out = run(stage, out)
            encoder_out.append(out)

        B, C, D, T = out.shape
        out = out.permute(3, 0, 1, 2)  # [T, B, C, D]
        if self.real_lstm:
            # the real LSTM runs f32 whatever the compute dtype, as the
            # reference's (se_tpu/models/dccrn.py:215-222)
            out = self.tranform(self.enhance(out.float().reshape(T, B, C * D)))
            out = out.reshape(T, B, C, D)
        else:
            r_in = out[:, :, : C // 2].reshape(T, B, C // 2 * D)
            i_in = out[:, :, C // 2 :].reshape(T, B, C // 2 * D)
            for rnn in self.enhance:
                r_in, i_in = rnn([r_in, i_in])
            out = torch.cat(
                [r_in.reshape(T, B, C // 2, D), i_in.reshape(T, B, C // 2, D)], dim=2
            )
        out = out.permute(1, 2, 3, 0).to(self.compute_dtype)  # [B, C, D, T]

        for idx, stage in enumerate(self.decoder):
            if self.skip:
                out = complex_cat([out, encoder_out[-1 - idx]], 1)
            out = run(lambda x, stage=stage: stage(x)[..., 1:], out)  # causal time trim per stage
        out = out.float()  # the mask and the iSTFT in f32

        mask_real = F.pad(out[:, 0], (0, 0, 1, 0))  # re-pad the DC bin
        mask_imag = F.pad(out[:, 1], (0, 0, 1, 0))
        if direct:  # the decoder's output is the spectrum
            target_specs = self.stft(targets)
            out_wav = self.istft(torch.cat([mask_real, mask_imag], dim=1))[:, 0]
            return (mask_real, target_specs[:, :dim], mask_imag, target_specs[:, dim:],
                    torch.clamp(out_wav, -1.0, 1.0))
        out_real, out_imag = self._apply_mask(mask_real, mask_imag, real, imag)
        out_wav = self.istft(torch.cat([out_real, out_imag], dim=1))[:, 0]
        return out_real, out_imag, torch.clamp(out_wav, -1.0, 1.0)

    def _apply_mask(self, mask_real, mask_imag, real, imag):
        """The E, C or R mask ``(mask_real, mask_imag)`` on the noisy
        spectrum ``(real, imag)``, each ``[B, fft_len // 2 + 1, T]`` f32 ->
        ``(out_real, out_imag)``."""
        if self.masking_mode == "E":
            spec_mags = torch.sqrt(real**2 + imag**2 + 1e-8)
            spec_phase = torch.atan2(imag, real)
            mask_mags = complex_mag(mask_real, mask_imag)
            real_phase = mask_real / (mask_mags + 1e-8)
            imag_phase = mask_imag / (mask_mags + 1e-8)
            mask_phase = safe_arctan2(imag_phase, real_phase)
            est_mags = torch.tanh(mask_mags) * spec_mags
            est_phase = spec_phase + mask_phase
            return est_mags * torch.cos(est_phase), est_mags * torch.sin(est_phase)
        if self.masking_mode == "C":
            return real * mask_real - imag * mask_imag, real * mask_imag + imag * mask_real
        return real * mask_real, imag * mask_imag  # "R"
