"""Weight carry-over from the JAX package (counterpart of
``se_tpu/utils/torch_export.py``).

The JAX package keeps its weights as a ``{params, batch_stats}`` tree in
torch layouts (OIHW convs, ``[4H, In]`` gate matrices, ``[out, in]``
linears).  :func:`dccrn_state_dict_from_jax` maps that tree, given as
nested dicts of numpy arrays, onto the reference's state-dict grammar
(``encoder.{i}.0.real_conv.weight``, ``enhance.{l}.real_lstm.weight_ih_l0``,
...), which is also the port's module naming, so the port's DCCRN loads it
with ``load_state_dict(strict=True)``.  A JAX-trained checkpoint reaches
the card through the ``{'model', 'optimizer', 'epoch'}`` blob that
``python -m se_tpu.utils.torch_export`` writes, read by
:func:`load_reference_checkpoint`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy.signal import get_window

from ..config import Config

_LSTM_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _conv_stft_buffers(win_len: int, fft_len: int) -> Dict[str, np.ndarray]:
    """The reference's registered STFT buffers.  As in the reference, the
    window is a periodic Hann whatever the configured window type."""
    window = get_window("hann", win_len, fftbins=True)
    basis = np.fft.rfft(np.eye(fft_len))[:win_len]
    kernel = np.concatenate([basis.real, basis.imag], 1).T
    inv = np.linalg.pinv(kernel).T * window
    fwd = kernel * window
    return {
        "stft.weight": fwd[:, None, :].astype(np.float32),
        "istft.weight": inv[:, None, :].astype(np.float32),
        "istft.window": window[None, :, None].astype(np.float32),
        "istft.enframe": np.eye(win_len, dtype=np.float32)[:, None, :],
    }


def _bn(out, prefix, name, params, bstats):
    p = params[name]
    if "Wrr" in p:
        raise NotImplementedError(
            "ComplexBatchNorm (use_cbn) is not ported yet (ROADMAP.md, Queue 1)"
        )
    out[f"{prefix}.weight"] = p["weight"]
    out[f"{prefix}.bias"] = p["bias"]
    out[f"{prefix}.running_mean"] = bstats[name]["running_mean"]
    out[f"{prefix}.running_var"] = bstats[name]["running_var"]
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _stage_count(params, section: str) -> int:
    return sum(1 for k in params if k.startswith(f"{section}_") and k.endswith("_conv"))


def dccrn_state_dict_from_jax(params, batch_stats, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX DCCRN ``params``/``batch_stats`` trees -> reference-grammar state dict."""
    if "tranform" in params:
        raise NotImplementedError(
            "DCCRN lstm='real' is not ported yet (ROADMAP.md, Queue 1)"
        )
    out = {}
    for i in range(_stage_count(params, "encoder")):
        c = params[f"encoder_{i}_conv"]
        for part in ("real", "imag"):
            out[f"encoder.{i}.0.{part}_conv.weight"] = c[f"{part}_weight"]
            out[f"encoder.{i}.0.{part}_conv.bias"] = c[f"{part}_bias"]
        _bn(out, f"encoder.{i}.1", f"encoder_{i}_bn", params, batch_stats)
        out[f"encoder.{i}.2.weight"] = params[f"encoder_{i}_prelu"]["weight"]

    li = 0
    while f"enhance_{li}" in params:
        blk = params[f"enhance_{li}"]
        for part in ("real", "imag"):
            for leaf in _LSTM_LEAVES:
                out[f"enhance.{li}.{part}_lstm.{leaf}_l0"] = blk[f"{part}_{leaf}"]
        for trans in ("r_trans", "i_trans"):
            if trans in blk:
                out[f"enhance.{li}.{trans}.weight"] = blk[trans]["weight"]
                out[f"enhance.{li}.{trans}.bias"] = blk[trans]["bias"]
        li += 1

    for i in range(_stage_count(params, "decoder")):
        c = params[f"decoder_{i}_conv"]
        for part in ("real", "imag"):
            out[f"decoder.{i}.0.{part}_conv.weight"] = c[f"{part}_weight"]
            out[f"decoder.{i}.0.{part}_conv.bias"] = c[f"{part}_bias"]
        if f"decoder_{i}_bn" in params:
            _bn(out, f"decoder.{i}.1", f"decoder_{i}_bn", params, batch_stats)
            out[f"decoder.{i}.2.weight"] = params[f"decoder_{i}_prelu"]["weight"]

    out.update(_conv_stft_buffers(cfg.stft.win_len, cfg.stft.fft_len))
    return {k: _tensor(v) for k, v in out.items()}


def random_dccrn_params(cfg: Config, seed: int = 0):
    """A DCCRN ``(params, batch_stats)`` tree in the JAX package's layout,
    drawn from ``numpy.random.default_rng(seed)``: the reference's
    initialisation for conv, LSTM and linear weights; conv biases, BatchNorm
    affine terms and running statistics away from their zero or identity
    initial values, so that a test of them can fail."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(f32)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(f32)

    params, bstats = {}, {}

    def bn(name, n):
        params[name] = {"weight": 1 + normal(n, 0.1), "bias": normal(n, 0.1)}
        bstats[name] = {"running_mean": normal(n, 0.1),
                        "running_var": rng.uniform(0.5, 1.5, n).astype(f32)}

    def conv(name, w_shape, co):
        params[name] = {f"{p}_{k}": (normal(w_shape, 0.05) if k == "weight" else normal(co, 0.05))
                        for p in ("real", "imag") for k in ("weight", "bias")}

    kn = (2,) + tuple(cfg.dccrn.kernel_num)
    ks = cfg.dccrn.kernel_size
    n_stage = len(kn) - 1
    for i in range(n_stage):
        conv(f"encoder_{i}_conv", (kn[i + 1] // 2, kn[i] // 2, ks, 2), kn[i + 1] // 2)
        bn(f"encoder_{i}_bn", kn[i + 1])
        params[f"encoder_{i}_prelu"] = {"weight": np.full((1,), 0.25, f32)}

    hidden_dim = cfg.stft.fft_len // (2 ** len(kn))
    units, layers = cfg.dccrn.rnn_units // 2, cfg.dccrn.rnn_layers
    for li in range(layers):
        in_dim = (hidden_dim * kn[-1] if li == 0 else cfg.dccrn.rnn_units) // 2
        b = 1.0 / np.sqrt(units)
        blk = {}
        for part in ("real", "imag"):
            blk[f"{part}_weight_ih"] = uniform((4 * units, in_dim), b)
            blk[f"{part}_weight_hh"] = uniform((4 * units, units), b)
            blk[f"{part}_bias_ih"] = uniform((4 * units,), b)
            blk[f"{part}_bias_hh"] = uniform((4 * units,), b)
        if li == layers - 1:
            proj = hidden_dim * kn[-1] // 2
            for trans in ("r_trans", "i_trans"):
                blk[trans] = {"weight": uniform((proj, units), b), "bias": uniform((proj,), b)}
        params[f"enhance_{li}"] = blk

    for d, idx in enumerate(range(n_stage, 0, -1)):
        co = kn[idx - 1] // 2  # input: kn[idx] channels doubled by the skip, halved
        conv(f"decoder_{d}_conv", (kn[idx], co, ks, 2), co)
        if idx != 1:
            bn(f"decoder_{d}_bn", kn[idx - 1])
            params[f"decoder_{d}_prelu"] = {"weight": np.full((1,), 0.25, f32)}
    return params, bstats


def save_reference_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], epoch: int = 0) -> str:
    """Write the reference's ``{'model', 'optimizer', 'epoch'}`` blob."""
    torch.save({"model": state_dict, "optimizer": {}, "epoch": int(epoch)}, path)
    return path


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read a ``{'model', 'optimizer', 'epoch'}`` blob -> ``(state_dict, epoch)``.
    Tensors are loaded on the CPU and only tensors and plain containers are
    accepted (``weights_only``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob["model"], int(blob.get("epoch", 0))
