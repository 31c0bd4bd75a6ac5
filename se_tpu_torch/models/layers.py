"""Layers with reference semantics and initialisation (counterpart of
``se_tpu/models/layers.py``).

Parameters and buffers carry the reference's attribute names
(``real_conv.weight``, ``real_lstm.weight_ih_l0``, ``running_mean``, ...)
so a reference state dict loads with ``strict=True``.  Every random
initialisation draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import conv as conv_ops
from ..ops import rnn as rnn_ops
from ..ops import shard
from ..ops.activations import prelu
from ..ops.fused_conv import fused_complex_conv2d
from ..ops.norms import ComplexBnState, batch_norm_2d, complex_batch_norm


def _normal05(generator: torch.Generator, shape) -> torch.Tensor:
    """The reference's conv init, N(0, 0.05)."""
    return torch.randn(shape, generator=generator) * 0.05


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class TorchLinear(nn.Module):
    """``nn.Linear`` semantics and init, U(+-1/sqrt(in_features))."""

    def __init__(self, in_features: int, out_features: int, *, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(_uniform(generator, (out_features, in_features), bound))
        self.bias = nn.Parameter(_uniform(generator, (out_features,), bound))

    def forward(self, x):
        return x @ self.weight.T.to(x.dtype) + self.bias.to(x.dtype)


# How many rematerialised forwards are running (remat's recompute in the
# backward).  A train-mode BatchNorm in one takes its batch statistics again
# but leaves its running statistics and num_batches_tracked as the first
# forward left them, as flax's nn.remat discards the recompute's updates.
_recomputing = 0


@contextlib.contextmanager
def _recompute():
    global _recomputing
    _recomputing += 1
    try:
        yield
    finally:
        _recomputing -= 1


def remat(fn, *args):
    """``fn(*args)`` with nothing of it kept for the backward but ``args``:
    the backward runs ``fn`` again to recompute its activations
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of flax's
    ``nn.remat``.  ``fn`` draws no random numbers."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute()))


class TorchBatchNorm2d(nn.Module):
    """``nn.BatchNorm2d`` semantics: running statistics in eval mode, batch
    statistics and a momentum update of the running buffers in train mode."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        y, new_mean, new_var = batch_norm_2d(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.training, self.momentum, self.eps,
        )
        if self.training and not _recomputing:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
                self.num_batches_tracked += 1
        return y


class ComplexBatchNorm(nn.Module):
    """The whitening complex BatchNorm over ``num_features`` channels (real
    and imaginary together): parameters ``Wrr``, ``Wri``, ``Wii``, ``Br``,
    ``Bi`` and buffers ``RMr``, ``RMi``, ``RVrr``, ``RVri``, ``RVii``, each of
    ``num_features // 2``, under the reference's names.  ``Wri`` is drawn from
    U(-0.9, 0.9) with ``generator``."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 *, generator: torch.Generator):
        super().__init__()
        C = num_features // 2
        self.momentum, self.eps = momentum, eps
        self.Wrr = nn.Parameter(torch.ones(C))
        self.Wri = nn.Parameter(_uniform(generator, (C,), 0.9))
        self.Wii = nn.Parameter(torch.ones(C))
        self.Br = nn.Parameter(torch.zeros(C))
        self.Bi = nn.Parameter(torch.zeros(C))
        for name, init in (("RMr", torch.zeros), ("RMi", torch.zeros), ("RVrr", torch.ones),
                           ("RVri", torch.zeros), ("RVii", torch.ones)):
            self.register_buffer(name, init(C))

    def forward(self, x):
        state = ComplexBnState(*(getattr(self, n) for n in ComplexBnState._fields))
        y, new = complex_batch_norm(x, self.Wrr, self.Wri, self.Wii, self.Br, self.Bi, state,
                                    self.training, self.momentum, self.eps)
        if self.training and not _recomputing:
            with torch.no_grad():
                for name, value in zip(ComplexBnState._fields, new):
                    getattr(self, name).copy_(value)
        return y


class PReLU(nn.Module):
    """``nn.PReLU`` with one shared slope, initialised to 0.25."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return prelu(x, self.weight)


class CPReLU(nn.Module):
    """A PReLU for each half of the channels (real, then imaginary), slopes
    ``r_weight`` and ``i_weight``, each initialised to 0.25."""

    def __init__(self):
        super().__init__()
        self.r_weight = nn.Parameter(torch.full((1,), 0.25))
        self.i_weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        C = x.shape[1]
        r, i = x[:, : C // 2], x[:, C // 2 :]
        return torch.cat([prelu(r, self.r_weight), prelu(i, self.i_weight)], dim=1)


class _ConvWeights(nn.Module):
    """Weight and bias of one component convolution, named as the
    reference's inner ``nn.Conv2d``/``nn.ConvTranspose2d``."""

    def __init__(self, weight_shape, out_channels: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(_normal05(generator, weight_shape))
        self.bias = nn.Parameter(torch.zeros(out_channels))


def _complex_bias(real_conv, imag_conv):
    # The reference applies both component convs, each with its bias, to
    # both inputs: the real output carries br - bi, the imaginary br + bi.
    br, bi = real_conv.bias, imag_conv.bias
    return torch.cat([br - bi, br + bi])


class ComplexConv2d(nn.Module):
    """Complex convolution as one real convolution with the 2x2 block
    kernel ``[[wr, -wi], [wi, wr]]``.  Channels are real block then
    imaginary block; ``in_channels``/``out_channels`` count both.  Time is
    padded on the left only (causal); frequency inside the conv.

    With ``use_pallas`` and the DCCRN encoder's geometry (kernel (5, 2),
    stride (2, 1), padding (2, 1)), the conv runs as the JAX package's fused
    path does: the real and imaginary inputs stacked along the batch, the
    real and imaginary filters along the channels, one hand-written kernel
    (``ops/fused_conv.py``), then the four products recombined."""

    def __init__(self, in_channels, out_channels, kernel_size=(1, 1), stride=(1, 1),
                 padding=(0, 0), *, use_pallas: bool = False, generator: torch.Generator):
        super().__init__()
        ci, co = in_channels // 2, out_channels // 2
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.fused = use_pallas and (
            (tuple(kernel_size), self.stride, self.padding) == ((5, 2), (2, 1), (2, 1))
        )
        self.real_conv = _ConvWeights((co, ci, *kernel_size), co, generator)
        self.imag_conv = _ConvWeights((co, ci, *kernel_size), co, generator)

    def forward(self, x):
        if self.fused:
            return self._fused_forward(x)
        ph, pw = self.padding
        x = F.pad(x, (pw, 0))
        wr, wi = self.real_conv.weight, self.imag_conv.weight
        w = torch.cat([torch.cat([wr, -wi], 1), torch.cat([wi, wr], 1)], 0)
        bias = _complex_bias(self.real_conv, self.imag_conv)
        return conv_ops.conv2d(x, w, bias, stride=self.stride, padding=(ph, 0))

    def _fused_forward(self, x):
        B, ci = x.shape[0], x.shape[1] // 2
        co = self.real_conv.weight.shape[0]
        z = torch.cat([x[:, :ci], x[:, ci:]], 0)
        w = torch.cat([self.real_conv.weight, self.imag_conv.weight], 0)
        bias = torch.cat([self.real_conv.bias, self.imag_conv.bias])
        y = fused_complex_conv2d(z, w, bias)
        r2r, r2i = y[:B, :co], y[:B, co:]
        i2r, i2i = y[B:, :co], y[B:, co:]
        return torch.cat([r2r - i2i, r2i + i2r], 1)


class ComplexConvTranspose2d(nn.Module):
    """Complex transposed convolution as one real one; the block kernel
    sits on the ``[in, out]`` axes of torch's transposed-conv layout:
    ``[[wr, wi], [-wi, wr]]``."""

    def __init__(self, in_channels, out_channels, kernel_size=(1, 1), stride=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), *, generator: torch.Generator):
        super().__init__()
        ci, co = in_channels // 2, out_channels // 2
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.output_padding = tuple(output_padding)
        self.real_conv = _ConvWeights((ci, co, *kernel_size), co, generator)
        self.imag_conv = _ConvWeights((ci, co, *kernel_size), co, generator)

    def forward(self, x):
        wr, wi = self.real_conv.weight, self.imag_conv.weight
        w = torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0)
        bias = _complex_bias(self.real_conv, self.imag_conv)
        return conv_ops.conv_transpose2d(
            x, w, bias, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )


class RealConv2d(nn.Module):
    """``nn.Conv2d`` held as ``.conv``, the reference's wrapper: time is
    padded on the left only (causal), frequency inside the conv."""

    def __init__(self, in_channels, out_channels, kernel_size=(1, 1), stride=(1, 1),
                 padding=(0, 0), *, generator: torch.Generator):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.conv = _ConvWeights((out_channels, in_channels, *kernel_size), out_channels,
                                 generator)

    def forward(self, x):
        ph, pw = self.padding
        x = F.pad(x, (pw, 0))
        return conv_ops.conv2d(x, self.conv.weight, self.conv.bias, stride=self.stride,
                               padding=(ph, 0))


class ConvTranspose2d(_ConvWeights):
    """A bare ``nn.ConvTranspose2d`` (``weight``, ``bias``), as the
    reference's CRN decoder holds it without skip connections."""

    def __init__(self, in_channels, out_channels, kernel_size=(1, 1), stride=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), *, generator: torch.Generator):
        super().__init__((in_channels, out_channels, *kernel_size), out_channels, generator)
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.output_padding = tuple(output_padding)

    def forward(self, x):
        return conv_ops.conv_transpose2d(
            x, self.weight, self.bias, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )


class RealConvTranspose2d(nn.Module):
    """``nn.ConvTranspose2d`` held as ``.conv``, the reference's wrapper."""

    def __init__(self, in_channels, out_channels, kernel_size=(1, 1), stride=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), *, generator: torch.Generator):
        super().__init__()
        self.conv = ConvTranspose2d(in_channels, out_channels, kernel_size, stride, padding,
                                    output_padding, generator=generator)

    def forward(self, x):
        return self.conv(x)


def complex_cat(inputs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate complex tensors keeping the real-block || imaginary-block
    layout: all real halves first, then all imaginary halves."""
    halves = [x.chunk(2, dim=dim) for x in inputs]
    return torch.cat([r for r, _ in halves] + [i for _, i in halves], dim=dim)


class _LstmWeights(nn.Module):
    """One layer of ``nn.LSTM``'s parameters, under its names."""

    def __init__(self, input_size: int, hidden_size: int, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_size)
        G = 4 * hidden_size
        self.weight_ih_l0 = nn.Parameter(_uniform(generator, (G, input_size), bound))
        self.weight_hh_l0 = nn.Parameter(_uniform(generator, (G, hidden_size), bound))
        self.bias_ih_l0 = nn.Parameter(_uniform(generator, (G,), bound))
        self.bias_hh_l0 = nn.Parameter(_uniform(generator, (G,), bound))

    def params(self) -> rnn_ops.LstmParams:
        return rnn_ops.LstmParams(
            self.weight_ih_l0, self.weight_hh_l0, self.bias_ih_l0, self.bias_hh_l0
        )


class NavieComplexLSTM(nn.Module):
    """Complex LSTM as one 2-stack recurrence.

    Keeps the reference's shared-weight quirk: the real-weight stack runs
    over the doubled batch ``[real; imag]`` and gives r->r and i->r, the
    imaginary-weight stack r->i and i->i; then ``real = r2r - i2i`` and
    ``imag = i2r + r2i``.  Only a layer given ``projection_dim`` has the
    ``r_trans``/``i_trans`` projections.  Its state is the two stacks'
    ``(h, c)``, each ``[2, 2B, hidden_size // 2]`` f32.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 projection_dim: Optional[int] = None, *, generator: torch.Generator):
        super().__init__()
        in_dim, units = input_size // 2, hidden_size // 2
        self.real_lstm = _LstmWeights(in_dim, units, generator)
        self.imag_lstm = _LstmWeights(in_dim, units, generator)
        self.projection_dim = projection_dim
        if projection_dim is not None:
            self.r_trans = TorchLinear(units, projection_dim // 2, generator=generator)
            self.i_trans = TorchLinear(units, projection_dim // 2, generator=generator)

    def forward(self, inputs, state=None, return_state: bool = False):
        """``[real, imag]``, each ``[T, B, input_size // 2]``, from ``state``
        (zeros when None) -> ``[real, imag]``, and with ``return_state`` the
        final state."""
        real, imag = inputs
        stacked = rnn_ops.LstmParams(
            *[torch.stack([a, b]) for a, b in zip(self.real_lstm.params(),
                                                   self.imag_lstm.params())]
        )
        B = real.shape[1]
        z = torch.cat([real, imag], dim=1)  # [T, 2B, in_dim]
        ys, final = rnn_ops.lstm_stack(stacked, z, state)
        r2r, i2r = ys[0, :, :B], ys[0, :, B:]
        r2i, i2i = ys[1, :, :B], ys[1, :, B:]
        real_out = r2r - i2i
        imag_out = i2r + r2i
        if self.projection_dim is not None:
            real_out = self.r_trans(real_out)
            imag_out = self.i_trans(imag_out)
        if return_state:
            return [real_out, imag_out], final
        return [real_out, imag_out]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout`` in train mode on ``x [T, B, ...]``: each value
    kept with probability ``1 - rate`` (a uniform draw from ``generator``
    below it) and scaled by ``1 / (1 - rate)``, the rest set to 0.  The
    generator lives on x's device.  Inside ``shard.shard_context`` every
    rank draws the global batch's mask from the same generator and keeps
    its own rows, so a data-parallel step drops what the one-process step
    drops."""
    if generator is None:
        raise ValueError(
            "dropout in train mode draws its mask from an explicit torch.Generator; "
            "pass generator= (train_step passes one)"
        )
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(x)
    mask = shard.local_rows(
        x.shape, 1, lambda shape: torch.rand(shape, generator=generator, device=x.device)) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _TorchRNN(nn.Module):
    """Multi-layer unidirectional ``nn.LSTM``/``nn.GRU`` (sequence-major
    ``[T, B, In]``) under their parameter names ``weight_ih_l{k}``,
    ``weight_hh_l{k}``, ``bias_ih_l{k}`` and ``bias_hh_l{k}``, with their
    init U(+-1/sqrt(H)).  Each layer is one call of the subclass's ``_layer``
    from its state (zeros when none is given); in train mode, dropout at
    ``dropout`` follows every layer but the last.  Subclasses set ``_GATES``,
    the gate blocks a layer's weights stack (4 for the LSTM, 3 for the GRU).
    A state is a list of one entry a layer: ``(h, c)`` of ``[B, H]`` for the
    LSTM, ``h`` for the GRU."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        bound = 1.0 / math.sqrt(hidden_size)
        G = self._GATES * hidden_size
        for k in range(num_layers):
            in_size = input_size if k == 0 else hidden_size
            for name, shape in ((f"weight_ih_l{k}", (G, in_size)),
                                (f"weight_hh_l{k}", (G, hidden_size)),
                                (f"bias_ih_l{k}", (G,)), (f"bias_hh_l{k}", (G,))):
                setattr(self, name, nn.Parameter(_uniform(generator, shape, bound)))

    def _layer(self, params: rnn_ops.LstmParams, x: torch.Tensor, state):
        """One layer from ``state`` (None: zeros) -> ``(ys, final state)``."""
        raise NotImplementedError

    def forward(self, x, generator: Optional[torch.Generator] = None, state=None,
                return_state: bool = False):
        """``x [T, B, In]`` -> ``[T, B, H]``, and with ``return_state`` the
        final state; ``generator`` draws the dropout masks in train mode."""
        finals = []
        for k in range(self.num_layers):
            params = rnn_ops.LstmParams(
                getattr(self, f"weight_ih_l{k}"), getattr(self, f"weight_hh_l{k}"),
                getattr(self, f"bias_ih_l{k}"), getattr(self, f"bias_hh_l{k}"),
            )
            x, final = self._layer(params, x, None if state is None else state[k])
            finals.append(final)
            if self.training and self.dropout > 0 and k < self.num_layers - 1:
                x = dropout(x, self.dropout, generator)
        return (x, finals) if return_state else x


class TorchLSTM(_TorchRNN):
    """``nn.LSTM``: each layer runs in :func:`rnn_ops.lstm` (K2)."""

    _GATES = 4

    def _layer(self, params, x, state):
        return rnn_ops.lstm(params, x, *(state if state is not None else (None, None)))


class TorchGRU(_TorchRNN):
    """``nn.GRU``: each layer runs in :func:`rnn_ops.gru` (K3)."""

    _GATES = 3

    def _layer(self, params, x, state):
        return rnn_ops.gru(params, x, state)


_ACTIVATIONS = {
    None: lambda o: o,
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": lambda o: o.clamp(0.0, 6.0),
}


class SequenceModel(nn.Module):
    """A stacked LSTM or GRU (submodule ``sequence_model``), the linear map
    ``fc_output_layer`` and an optional activation (Tanh, ReLU, ReLU6 or
    None); input and output ``[B, F, T]``."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 num_layers: int = 2, sequence_model: str = "GRU",
                 output_activate_function: Optional[str] = "Tanh", dropout: float = 0.8,
                 *, generator: torch.Generator):
        super().__init__()
        rnns = {"LSTM": TorchLSTM, "GRU": TorchGRU}
        if sequence_model not in rnns:
            raise NotImplementedError(f"Not implemented {sequence_model}")
        if output_activate_function not in _ACTIVATIONS:
            raise NotImplementedError(
                f"Not implemented activation function {output_activate_function}"
            )
        self.sequence_model = rnns[sequence_model](
            input_size, hidden_size, num_layers, dropout, generator=generator
        )
        self.fc_output_layer = TorchLinear(hidden_size, output_size, generator=generator)
        self.activation = _ACTIVATIONS[output_activate_function]

    def forward(self, x, generator: Optional[torch.Generator] = None, state=None,
                return_state: bool = False):
        """``[B, F, T]`` from the RNN's ``state`` (zeros when None) -> ``[B,
        F', T]``, and with ``return_state`` the RNN's final state."""
        if x.ndim != 3:
            raise ValueError(f"SequenceModel takes [B, F, T], got {tuple(x.shape)}")
        o, final = self.sequence_model(x.permute(2, 0, 1), generator, state,
                                       return_state=True)  # [T, B, F]
        o = self.activation(self.fc_output_layer(o)).permute(1, 2, 0)
        return (o, final) if return_state else o
