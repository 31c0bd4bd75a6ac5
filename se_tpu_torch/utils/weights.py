"""Weight carry-over from the JAX package (counterpart of
``se_tpu/utils/torch_export.py``).

The JAX package keeps its weights as a ``{params, batch_stats}`` tree in
torch layouts (OIHW convs, ``[4H, In]`` gate matrices, ``[out, in]``
linears).  :func:`dccrn_state_dict_from_jax` maps that tree, given as
nested dicts of numpy arrays, onto the reference's state-dict grammar
(``encoder.{i}.0.real_conv.weight``, ``enhance.{l}.real_lstm.weight_ih_l0``,
...), which is also the port's module naming, so the port's DCCRN loads it
with ``load_state_dict(strict=True)``; :func:`crn_state_dict_from_jax` does
the same for CRN (``encoder.{i}.0.conv.weight``, ``enhance.weight_ih_l0``,
``tranform.weight``, ..., and without skip connections the bare
``decoder.{i}.0.weight``), :func:`fullsubnet_state_dict_from_jax` for
FullSubNet (``fb_model.sequence_model.weight_ih_l0``,
``sb_model.fc_output_layer.bias``, ...), and :func:`state_dict_from_jax`
picks by ``cfg.model``.  A JAX-trained checkpoint reaches
the card through the ``{'model', 'optimizer', 'epoch'}`` blob that
``python -m se_tpu.utils.torch_export`` writes, read by
:func:`load_reference_checkpoint`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy.signal import get_window

from ..config import Config
from ..ops.norms import ComplexBnState

_LSTM_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
_CBN_PARAMS = ("Wrr", "Wri", "Wii", "Br", "Bi")


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
    """One ``TorchBatchNorm2d`` or ``ComplexBatchNorm``: the complex one's
    running statistics are the fields of its ``state`` (``ComplexBnState``,
    in either package)."""
    p = params[name]
    if "Wrr" in p:
        for n in _CBN_PARAMS:
            out[f"{prefix}.{n}"] = p[n]
        for n in ComplexBnState._fields:
            out[f"{prefix}.{n}"] = getattr(bstats[name]["state"], n)
        return
    out[f"{prefix}.weight"] = p["weight"]
    out[f"{prefix}.bias"] = p["bias"]
    out[f"{prefix}.running_mean"] = bstats[name]["running_mean"]
    out[f"{prefix}.running_var"] = bstats[name]["running_var"]
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _stage_count(params, section: str) -> int:
    return sum(1 for k in params if k.startswith(f"{section}_") and k.endswith("_conv"))


def _real_lstm_bottleneck(out, params):
    """``enhance`` (a ``TorchLSTM``) and ``tranform`` (a ``TorchLinear``)."""
    for leaf, arr in params["enhance"].items():
        out[f"enhance.{leaf}"] = arr
    out["tranform.weight"] = params["tranform"]["weight"]
    out["tranform.bias"] = params["tranform"]["bias"]


def dccrn_state_dict_from_jax(params, batch_stats, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX DCCRN ``params``/``batch_stats`` trees -> reference-grammar state dict."""
    out = {}
    for i in range(_stage_count(params, "encoder")):
        c = params[f"encoder_{i}_conv"]
        for part in ("real", "imag"):
            out[f"encoder.{i}.0.{part}_conv.weight"] = c[f"{part}_weight"]
            out[f"encoder.{i}.0.{part}_conv.bias"] = c[f"{part}_bias"]
        _bn(out, f"encoder.{i}.1", f"encoder_{i}_bn", params, batch_stats)
        out[f"encoder.{i}.2.weight"] = params[f"encoder_{i}_prelu"]["weight"]

    if "tranform" in params:  # lstm="real"
        _real_lstm_bottleneck(out, params)
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


def crn_state_dict_from_jax(params, batch_stats, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX CRN ``params``/``batch_stats`` trees -> reference-grammar state
    dict.  Without skip connections the decoder's convs are the reference's
    bare ``nn.ConvTranspose2d`` (``decoder.{i}.0.weight``)."""
    out = {}
    for section in ("encoder", "decoder"):
        for i in range(_stage_count(params, section)):
            c = params[f"{section}_{i}_conv"]
            bare = section == "decoder" and not cfg.skip_type
            conv = f"{section}.{i}.0" if bare else f"{section}.{i}.0.conv"
            out[f"{conv}.weight"] = c["weight"]
            out[f"{conv}.bias"] = c["bias"]
            if f"{section}_{i}_bn" in params:
                _bn(out, f"{section}.{i}.1", f"{section}_{i}_bn", params, batch_stats)
                out[f"{section}.{i}.2.weight"] = params[f"{section}_{i}_prelu"]["weight"]
        if section == "encoder":
            _real_lstm_bottleneck(out, params)
    out.update(_conv_stft_buffers(cfg.stft.win_len, cfg.stft.fft_len))
    return {k: _tensor(v) for k, v in out.items()}


def fullsubnet_state_dict_from_jax(params, batch_stats, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX FullSubNet ``params`` tree -> reference-grammar state dict (LSTM or
    GRU alike: the leaves are named as ``nn.LSTM``'s and ``nn.GRU``'s).
    FullSubNet has no batch statistics."""
    out = {}
    for branch in ("fb_model", "sb_model"):
        for leaf, arr in params[branch]["sequence_model"].items():  # weight_ih_l0 ...
            out[f"{branch}.sequence_model.{leaf}"] = arr
        fc = params[branch]["fc_output_layer"]
        out[f"{branch}.fc_output_layer.weight"] = fc["weight"]
        out[f"{branch}.fc_output_layer.bias"] = fc["bias"]
    return {k: _tensor(v) for k, v in out.items()}


def state_dict_from_jax(params, batch_stats, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` trees of ``cfg.model`` -> reference-grammar
    state dict."""
    convert = {"DCCRN": dccrn_state_dict_from_jax, "CRN": crn_state_dict_from_jax,
               "FullSubNet": fullsubnet_state_dict_from_jax}
    return convert[cfg.model](params, batch_stats, cfg)


class _Draw:
    """The initial values of ``random_*_params``, from one numpy generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape, std):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def uniform(self, shape, bound):
        return self.rng.uniform(-bound, bound, shape).astype(np.float32)

    def batch_norm(self, params, bstats, name, n):
        """Affine terms and running statistics away from 1 and 0."""
        params[name] = {"weight": 1 + self.normal(n, 0.1), "bias": self.normal(n, 0.1)}
        bstats[name] = {"running_mean": self.normal(n, 0.1),
                        "running_var": self.rng.uniform(0.5, 1.5, n).astype(np.float32)}

    def complex_batch_norm(self, params, bstats, name, n):
        """``ComplexBatchNorm`` over ``n`` channels (``n // 2`` pairs): the
        affine terms away from the identity (``Wri`` from U(-0.9, 0.9), the
        layer's init), running means away from 0, running covariances
        positive definite and away from the identity."""
        C = n // 2
        params[name] = {"Wrr": 1 + self.normal(C, 0.1), "Wri": self.uniform(C, 0.9),
                        "Wii": 1 + self.normal(C, 0.1), "Br": self.normal(C, 0.1),
                        "Bi": self.normal(C, 0.1)}
        var = lambda: self.rng.uniform(0.5, 1.5, C).astype(np.float32)
        bstats[name] = {"state": ComplexBnState(
            RMr=self.normal(C, 0.1), RMi=self.normal(C, 0.1), RVrr=var(),
            RVri=self.uniform(C, 0.2), RVii=var())}

    def torch_rnn(self, input_size, hidden_size, num_layers, gates=4):
        """``TorchLSTM`` (``gates=4``) or ``TorchGRU`` (``gates=3``) leaves,
        U(+-1/sqrt(H)), in flax's order."""
        b, G = 1.0 / np.sqrt(hidden_size), gates * hidden_size
        out = {}
        for k in range(num_layers):
            in_size = input_size if k == 0 else hidden_size
            out[f"weight_ih_l{k}"] = self.uniform((G, in_size), b)
            out[f"weight_hh_l{k}"] = self.uniform((G, hidden_size), b)
            out[f"bias_ih_l{k}"] = self.uniform((G,), b)
            out[f"bias_hh_l{k}"] = self.uniform((G,), b)
        return out

    def linear(self, in_features, out_features):
        b = 1.0 / np.sqrt(in_features)
        return {"weight": self.uniform((out_features, in_features), b),
                "bias": self.uniform((out_features,), b)}


def random_crn_params(cfg: Config, seed: int = 0):
    """A CRN ``(params, batch_stats)`` tree in the JAX package's layout,
    drawn from ``numpy.random.default_rng(seed)`` as
    :func:`random_dccrn_params` draws DCCRN's."""
    d = _Draw(seed)
    params, bstats = {}, {}
    kn = (2,) + tuple(cfg.dccrn.kernel_num)
    ks = cfg.crn.kernel_size
    n_stage = len(kn) - 1

    def stage(section, i, w_shape, co, bn):
        params[f"{section}_{i}_conv"] = {"weight": d.normal(w_shape, 0.05),
                                         "bias": d.normal(co, 0.05)}
        if bn:
            d.batch_norm(params, bstats, f"{section}_{i}_bn", co)
            params[f"{section}_{i}_prelu"] = {"weight": np.full((1,), 0.25, np.float32)}

    for i in range(n_stage):
        stage("encoder", i, (kn[i + 1] // 2, kn[i] // 2, ks, 2), kn[i + 1] // 2, True)
    H = cfg.crn.rnn_units // 2
    params["enhance"] = d.torch_rnn(cfg.crn.rnn_input_size, H, 1)
    params["tranform"] = d.linear(H, cfg.crn.rnn_input_size)
    for n, idx in enumerate(range(n_stage, 0, -1)):
        # input: kn[idx] // 2 channels, doubled by the skip
        ci = kn[idx] if cfg.skip_type else kn[idx] // 2
        stage("decoder", n, (ci, kn[idx - 1] // 2, ks, 2), kn[idx - 1] // 2, idx != 1)
    return params, bstats


def random_dccrn_params(cfg: Config, seed: int = 0):
    """A DCCRN ``(params, batch_stats)`` tree in the JAX package's layout,
    drawn from ``numpy.random.default_rng(seed)``: the reference's
    initialisation for conv, LSTM and linear weights; conv biases, BatchNorm
    affine terms and running statistics away from their zero or identity
    initial values, so that a test of them can fail.  ``dccrn.use_cbn`` and
    ``skip_type`` shape the norms and the decoder's input channels."""
    d = _Draw(seed)
    params, bstats = {}, {}
    norm = d.complex_batch_norm if cfg.dccrn.use_cbn else d.batch_norm

    def conv(name, w_shape, co):
        params[name] = {f"{p}_{k}": (d.normal(w_shape, 0.05) if k == "weight"
                                     else d.normal(co, 0.05))
                        for p in ("real", "imag") for k in ("weight", "bias")}

    kn = (2,) + tuple(cfg.dccrn.kernel_num)
    ks = cfg.dccrn.kernel_size
    n_stage = len(kn) - 1
    for i in range(n_stage):
        conv(f"encoder_{i}_conv", (kn[i + 1] // 2, kn[i] // 2, ks, 2), kn[i + 1] // 2)
        norm(params, bstats, f"encoder_{i}_bn", kn[i + 1])
        params[f"encoder_{i}_prelu"] = {"weight": np.full((1,), 0.25, np.float32)}

    width = cfg.stft.fft_len // (2 ** len(kn)) * kn[-1]
    if cfg.lstm == "real":  # two layers, as the JAX model builds it
        params["enhance"] = d.torch_rnn(width, cfg.dccrn.rnn_units, 2)
        params["tranform"] = d.linear(cfg.dccrn.rnn_units, width)
    units, layers = cfg.dccrn.rnn_units // 2, cfg.dccrn.rnn_layers
    for li in range(layers if cfg.lstm == "complex" else 0):
        in_dim = (width if li == 0 else cfg.dccrn.rnn_units) // 2
        # flax names these leaves "{part}_weight_ih", without the "_l0"
        blk = {f"{part}_{leaf[:-3]}": v
               for part in ("real", "imag")
               for leaf, v in d.torch_rnn(in_dim, units, 1).items()}
        if li == layers - 1:
            for trans in ("r_trans", "i_trans"):
                # drawn with the LSTM's bound, 1/sqrt(units)
                blk[trans] = {"weight": d.uniform((width // 2, units), 1.0 / np.sqrt(units)),
                              "bias": d.uniform((width // 2,), 1.0 / np.sqrt(units))}
        params[f"enhance_{li}"] = blk

    for n, idx in enumerate(range(n_stage, 0, -1)):
        co = kn[idx - 1] // 2
        # input: kn[idx] channels, doubled by the skip, halved
        ci = kn[idx] if cfg.skip_type else kn[idx] // 2
        conv(f"decoder_{n}_conv", (ci, co, ks, 2), co)
        if idx != 1:
            norm(params, bstats, f"decoder_{n}_bn", kn[idx - 1])
            params[f"decoder_{n}_prelu"] = {"weight": np.full((1,), 0.25, np.float32)}
    return params, bstats


def random_fullsubnet_params(cfg: Config, seed: int = 0):
    """A FullSubNet ``(params, batch_stats)`` tree in the JAX package's
    layout, for ``cfg.sequence_model`` LSTM or GRU, drawn from
    ``numpy.random.default_rng(seed)`` with the reference's initialisation
    (U(+-1/sqrt(H)) for the RNNs, U(+-1/sqrt(fan_in)) for the linears).
    ``batch_stats`` is empty."""
    d = _Draw(seed)
    fsn = cfg.fullsubnet
    gates = {"LSTM": 4, "GRU": 3}[cfg.sequence_model]
    F = cfg.stft.num_freqs
    sb_in = (fsn.sb_num_neighbors * 2 + 1) + (fsn.fb_num_neighbors * 2 + 1)
    params = {}
    for name, in_size, out_size, hidden in (("fb_model", F, F, fsn.fb_model_hidden_size),
                                            ("sb_model", sb_in, 2, fsn.sb_model_hidden_size)):
        params[name] = {"sequence_model": d.torch_rnn(in_size, hidden, 2, gates),
                        "fc_output_layer": d.linear(hidden, out_size)}
    return params, {}


def save_reference_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], epoch: int = 0,
                              optimizer: Optional[dict] = None) -> str:
    """Write the reference's ``{'model', 'optimizer', 'epoch'}`` blob;
    ``optimizer`` is an optimiser's ``state_dict()`` (``{}`` when omitted)."""
    blob = {"model": state_dict, "optimizer": {} if optimizer is None else optimizer,
            "epoch": int(epoch)}
    torch.save(blob, path)
    return path


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read a ``{'model', 'optimizer', 'epoch'}`` blob -> ``(state_dict, epoch)``.
    Tensors are loaded on the CPU and only tensors and plain containers are
    accepted (``weights_only``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob["model"], int(blob.get("epoch", 0))
