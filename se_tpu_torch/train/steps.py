"""Train and validation steps (counterpart of ``make_train_step`` and
``make_eval_step`` in ``se_tpu/train/steps.py``: the five trainer
variants), and FullSubNet's cRM decode.

As the JAX step does, the ``perceptual`` variant passes the targets to the
model: the reference's perceptual loop calls ``model(inputs)``, which works
for DCCRN and fails for CRN, whose forward needs the targets."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..dsp.stft import istft, mag_phase, stft
from ..losses import main_loss, perceptual_loss
from ..ops.cirm import build_complex_ideal_ratio_mask, decompress_cIRM


def trainer_variant(cfg: Config) -> str:
    """The reference's five-way trainer dispatch."""
    if cfg.perceptual is not False:
        return "perceptual"
    if cfg.model == "FullSubNet":
        return "fullsubnet"
    if cfg.masking_mode == "Direct(None make)":
        return "dccrn_direct" if cfg.model == "DCCRN" else "crn_direct"
    return "masking"


def _fullsubnet_features(cfg: Config, inputs, targets):
    """``(noisy spectrum, noisy magnitude, compressed cIRM)`` through the
    framework STFT at ``cfg.stft.torch_hop``."""
    s = cfg.stft
    noisy_complex = stft(inputs, s.fft_len, s.torch_hop, s.win_len)
    clean_complex = stft(targets, s.fft_len, s.torch_hop, s.win_len)
    noisy_mag, _ = mag_phase(noisy_complex)
    return noisy_complex, noisy_mag, build_complex_ideal_ratio_mask(noisy_complex, clean_complex)


def fullsubnet_enhance(cfg: Config, cRM, noisy_complex, length: int) -> torch.Tensor:
    """cRM ``[B, F, T, 2]`` decoded, times the noisy spectrum, framework
    iSTFT -> ``[B, length]`` (reference: trainer.py:341-345)."""
    s = cfg.stft
    cRM = decompress_cIRM(cRM)
    nr, ni = noisy_complex.real, noisy_complex.imag
    enhanced_real = cRM[..., 0] * nr - cRM[..., 1] * ni
    enhanced_imag = cRM[..., 1] * nr + cRM[..., 0] * ni
    enhanced = torch.stack((enhanced_real, enhanced_imag), dim=-1)
    return istft(enhanced, s.fft_len, s.torch_hop, s.win_len, length=length)


def _perceptual(cfg: Config, model, inputs, targets):
    """``(main loss, perceptual loss, waveforms)``: the main loss on the
    waveform; LMS on the magnitudes (DCCRN: the targets' through the
    model's own STFT and the estimate's spectrum; CRN: its own estimated
    and target magnitudes), PMSQE on the waveforms."""
    if cfg.model == "DCCRN":
        real_spec, imag_spec, outputs = model(inputs, targets)
        clean_mags = est_mags = None
        if cfg.perceptual == "LMS":
            specs = model.stft(targets)
            dim = cfg.stft.fft_len // 2 + 1
            clean_mags = torch.sqrt(specs[:, :dim] ** 2 + specs[:, dim:] ** 2 + 1e-7)
            est_mags = torch.sqrt(real_spec**2 + imag_spec**2 + 1e-7)
    else:
        est_mags, clean_mags, outputs = model(inputs, targets)
    m_loss = main_loss(cfg.loss, outputs, targets)
    p_loss = perceptual_loss(cfg.perceptual, targets, outputs, clean_mags, est_mags)
    return m_loss, p_loss, outputs


def _loss_and_outputs(cfg: Config, variant: str, model, inputs, targets, generator=None):
    """The variant's ``(loss, aux, outputs)``: ``masking`` scores the
    waveform against the clean one; ``perceptual`` weighs that and the
    perceptual loss equally (both also in ``aux``, as ``main_loss`` and
    ``perceptual_loss``); ``dccrn_direct`` averages the losses of the real
    and the imaginary spectrum against the targets'; ``crn_direct`` scores
    CRN's magnitude against the clean magnitude; ``fullsubnet`` scores the
    cIRM against the predicted cRM, in the reference's argument order, and
    returns ``(cRM, noisy spectrum)``."""
    aux = {}
    if variant == "fullsubnet":
        noisy_complex, noisy_mag, cIRM = _fullsubnet_features(cfg, inputs, targets)
        cRM = model(noisy_mag, generator=generator)
        return main_loss(cfg.loss, cIRM, cRM), aux, (cRM, noisy_complex)
    if variant == "perceptual":
        m_loss, p_loss, outputs = _perceptual(cfg, model, inputs, targets)
        r1, r2 = 1.0, 1.0  # the reference's constraint ratio
        aux = {"main_loss": r1 * m_loss, "perceptual_loss": r2 * p_loss}
        return (r1 * m_loss + r2 * p_loss) / (r1 + r2), aux, outputs
    if variant == "dccrn_direct":
        out_r, tgt_r, out_i, tgt_i, outputs = model(inputs, targets)
        loss = (main_loss(cfg.loss, out_r, tgt_r) + main_loss(cfg.loss, out_i, tgt_i)) / 2
        return loss, aux, outputs
    if variant == "crn_direct":
        out_mag, tgt_mag, outputs = model(inputs, targets)
        return main_loss(cfg.loss, out_mag, tgt_mag), aux, outputs
    _, _, outputs = model(inputs)
    return main_loss(cfg.loss, outputs, targets), aux, outputs


def _batch(model: torch.nn.Module, inputs, targets):
    dev = next(model.parameters()).device
    return (torch.as_tensor(inputs, dtype=torch.float32, device=dev),
            torch.as_tensor(targets, dtype=torch.float32, device=dev))


def _dropout_generator(cfg: Config, model: torch.nn.Module) -> torch.Generator:
    """The model's own dropout generator: made at its first train step on
    the model's device, seeded from ``cfg.train.seed``, and kept on the
    model so that later steps draw fresh masks."""
    gen = getattr(model, "dropout_generator", None)
    if gen is None:
        dev = next(model.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
        model.dropout_generator = gen
    return gen


def train_step(cfg: Config, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               inputs, targets, generator: Optional[torch.Generator] = None) -> dict:
    """One optimisation step on a ``(noisy, clean)`` batch, both ``[B, L]``,
    on the model's device -> ``{"loss": scalar}`` (the mean over
    micro-batches, detached; the ``perceptual`` variant adds ``main_loss``
    and ``perceptual_loss``, each likewise the mean over micro-batches).

    The model is put in train mode: BatchNorm normalises with the batch's
    statistics and moves its running buffers, and FullSubNet's dropout draws
    its masks from ``generator`` (a ``torch.Generator`` on the model's
    device; default: the model's own, seeded from ``cfg.train.seed`` at its
    first step).  With ``cfg.train.grad_accum
    = A > 1`` the batch runs as A sequential micro-batches of ``B / A``
    rows; each updates the running statistics in turn, their gradients are
    summed and divided by A, and the optimiser takes one step, as the JAX
    step's scan does.  The averaged gradients are left in each
    parameter's ``.grad``.
    """
    accum = cfg.train.grad_accum
    params, grads, sums = accumulate_gradients(cfg, model, inputs, targets, generator)
    for p, g in zip(params, grads):
        p.grad = g / accum
    optimizer.step()
    return {k: v / accum for k, v in sums.items()}


def accumulate_gradients(cfg: Config, model: torch.nn.Module, inputs, targets,
                         generator: Optional[torch.Generator] = None) -> tuple:
    """The train-mode forward and backward of :func:`train_step` without the
    optimiser -> ``(params, the gradients summed over the micro-batches,
    {metric: sum over the micro-batches})``."""
    variant = trainer_variant(cfg)
    accum = cfg.train.grad_accum
    inputs, targets = _batch(model, inputs, targets)
    if inputs.shape[0] % accum:
        raise ValueError(f"batch {inputs.shape[0]} does not split into {accum} micro-batches")
    if generator is None and variant == "fullsubnet":
        generator = _dropout_generator(cfg, model)
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    # Summed out of place, not by repeated backward(): autograd may hand
    # two parameters views of one gradient tensor (an LSTM's b_ih and b_hh
    # both receive the gradient of their sum), and an in-place
    # accumulation into one would then add to the other as well.
    grads, sums = None, {}
    for x, y in zip(inputs.chunk(accum), targets.chunk(accum)):
        loss, aux, _ = _loss_and_outputs(cfg, variant, model, x, y, generator)
        g = torch.autograd.grad(loss, params)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        for k, v in {"loss": loss, **aux}.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    return params, grads, sums


def eval_step(cfg: Config, model: torch.nn.Module, inputs, targets):
    """Loss and enhanced waveforms of one ``(noisy, clean)`` batch, both
    ``[B, L]``, on the model's device -> ``({"loss": scalar}, wavs [B, L'])``;
    the ``perceptual`` variant's metrics add ``main_loss`` and
    ``perceptual_loss``."""
    variant = trainer_variant(cfg)
    model.eval()
    with torch.inference_mode():
        inputs, targets = _batch(model, inputs, targets)
        loss, aux, outputs = _loss_and_outputs(cfg, variant, model, inputs, targets)
        if variant == "fullsubnet":
            outputs = fullsubnet_enhance(cfg, *outputs, length=inputs.shape[-1])
    return {"loss": loss, **aux}, outputs
