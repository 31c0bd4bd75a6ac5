"""The PyTorch port's streaming DSP (``se_tpu_torch/dsp/streaming_stft.py``)
and the cumulative norms' chunk carries (``se_tpu_torch/ops/norms.py``)
against the JAX package on the CPU.

``StreamingStft``, ``StreamingIstft`` and ``StreamingConvIstft`` are pushed
the same chunks in both packages, ragged ones and empty ones among them,
and the concatenated output is held to the JAX stream's at atol 1e-5 and to
the port's own batch ``stft``, ``istft`` or ``conv_istft`` at atol 1e-4 (a
batch transform sums its frames' overlap-add in another order than the
stream does).  The synthesis is compared where the caller keeps it, inside
the batch path's edge trim: at the trimmed edges the envelope it divides
by falls to the window's first values (1e-7 and less), which turn the two
packages' inverse FFTs' last-bit differences into 1e-4.  Waveforms are N(0, 0.1^2), speech's scale.  The norm
carries, chunk by chunk, are held to JAX's carries at atol 1e-5 and to the
port's batch cumulative norms at atol 1e-5 (the carry adds the running sum
to each chunk's own cumsum, so the two round the sum apart)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from se_tpu.dsp import conv_stft as jconv_stft
from se_tpu.dsp import frame_stft, make_conv_stft_kernels
from se_tpu.dsp import streaming_stft as jstream
from se_tpu.ops import norms as jnorms

from se_tpu_torch.dsp import streaming_stft as tstream
from se_tpu_torch.dsp.stft import conv_istft, conv_stft_bases, istft, stft
from se_tpu_torch.ops import norms

ATOL_JAX = 1e-5
ATOL_BATCH = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _wav(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _push_all(stream, pieces, to):
    """Push ``pieces`` through ``stream`` (state carried) and its flush ->
    the concatenated outputs as numpy."""
    state, outs = None, []
    for piece in pieces:
        y, state = stream.push(to(piece), state)
        outs.append(np.asarray(y))
    outs.append(np.asarray(stream.flush(state)))
    return np.concatenate(outs, axis=-1)


# --- analysis -------------------------------------------------------------------


@pytest.mark.parametrize("L,bounds", [
    (4800, None), (4801, None), (1500, None),
    (7000, [(0, 900), (900, 1000), (1000, 1000), (1000, 4321), (4321, 7000)]),
], ids=["4800", "4801", "1500", "ragged-and-empty"])
def test_streaming_stft_matches_jax_and_batch(L, bounds):
    """Chunks of 1500 samples (5 hops), or ragged ones with an empty push,
    then ``flush``: ``L // hop + 1`` frames, torch.stft's count."""
    wav = _wav(L, (2, L))
    bounds = bounds or [(lo, lo + 1500) for lo in range(0, L, 1500)]
    pieces = [wav[:, lo:hi] for lo, hi in bounds]
    got = _push_all(tstream.StreamingStft(512, 300, 400), pieces, _t)
    want = _push_all(jstream.StreamingStft(512, 300, 400), pieces, jnp.asarray)
    batch = stft(_t(wav), 512, 300, 400).numpy()
    assert got.shape == want.shape == batch.shape == (2, 257, L // 300 + 1)
    np.testing.assert_allclose(got, want, atol=ATOL_JAX)
    np.testing.assert_allclose(got, batch, atol=ATOL_BATCH)


def test_streaming_stft_first_chunk_too_short():
    for stream, to in ((tstream.StreamingStft(), _t), (jstream.StreamingStft(), jnp.asarray)):
        with pytest.raises(ValueError, match="reflect pad"):
            stream.push(to(np.zeros((1, 256), np.float32)))


# --- synthesis ------------------------------------------------------------------


@pytest.mark.parametrize("L,bounds", [
    (4801, None), (16000, None), (7000, [(0, 1), (1, 1), (1, 7), (7, None)]),
], ids=["4801", "16000", "ragged-and-empty"])
def test_streaming_istft_matches_jax_and_batch(L, bounds):
    """Frames of ``stft`` pushed 5 at a time (or ragged, with an empty
    push), then ``flush``; ``[n_fft // 2 : n_fft // 2 + L]`` of the stream
    is ``istft(..., length=L)``."""
    spec = frame_stft(jnp.asarray(_wav(L + 1, (2, L))), 512, 300, 400)
    T = spec.shape[-1]
    bounds = [(lo, hi or T) for lo, hi in bounds] if bounds else [
        (lo, lo + 5) for lo in range(0, T, 5)]
    pieces = [np.asarray(spec)[..., lo:hi] for lo, hi in bounds]
    got = _push_all(tstream.StreamingIstft(512, 300, 400), pieces, _t)
    want = _push_all(jstream.StreamingIstft(512, 300, 400), pieces, jnp.asarray)
    assert got.shape == want.shape
    kept = slice(256, 256 + L)
    np.testing.assert_allclose(got[:, kept], want[:, kept], atol=ATOL_JAX)
    batch = istft(_t(spec), 512, 300, 400, length=L).numpy()
    np.testing.assert_allclose(got[:, kept], batch, atol=ATOL_BATCH)


def test_streaming_roundtrip_streams_both_ways():
    """Analysis chunks straight into synthesis chunks rebuild the waveform
    where the window's envelope is whole, never holding the whole signal."""
    L = 9000
    wav = _wav(5, (1, L))
    ana, syn = tstream.StreamingStft(), tstream.StreamingIstft()
    astate = sstate = None
    outs = []
    for lo in range(0, L, 1500):
        spec, astate = ana.push(_t(wav[:, lo : lo + 1500]), astate)
        y, sstate = syn.push(spec, sstate)
        outs.append(y)
    y, sstate = syn.push(ana.flush(astate), sstate)
    got = torch.cat([*outs, y, syn.flush(sstate)], dim=-1).numpy()[:, 256 : 256 + L]
    np.testing.assert_allclose(got[:, 512:-512], wav[:, 512:-512], atol=ATOL_BATCH)


@pytest.mark.parametrize("L,step", [(16000, 7), (16050, 7), (16000, None)],
                         ids=["16000", "16050", "ragged-and-empty"])
def test_streaming_conv_istft_matches_jax_and_batch(L, step):
    """The conv-STFT's frames pushed 7 at a time (or ragged, with an empty
    push), then ``flush``; trimmed by ``win_len - hop`` at each end, the
    stream is ``conv_istft``."""
    k = make_conv_stft_kernels(400, 100, 512)
    spec = np.asarray(jconv_stft(jnp.asarray(_wav(L, (2, L))), k))
    T = spec.shape[-1]
    bounds = ([(lo, lo + step) for lo in range(0, T, step)] if step
              else [(0, 3), (3, 3), (3, 40), (40, T)])
    pieces = [spec[..., lo:hi] for lo, hi in bounds]
    _, inv, window = conv_stft_bases(400, 512, "hanning")
    got = _push_all(tstream.StreamingConvIstft(_t(inv), _t(window), 100), pieces, _t)
    want = _push_all(jstream.StreamingConvIstft(k), pieces, jnp.asarray)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, 300:-300], want[:, 300:-300], atol=ATOL_JAX)
    batch = conv_istft(_t(spec), _t(inv), _t(window), 100)[:, 0].numpy()
    np.testing.assert_allclose(got[:, 300:-300], batch, atol=ATOL_BATCH)


# --- the cumulative norms' carries ----------------------------------------------


@pytest.mark.parametrize("norm_type", ["cumulative_laplace_norm", "cumulative_layer_norm"])
def test_norm_carries_match_jax_and_batch(norm_type):
    """``[B, C, F, T]`` magnitudes in chunks of 5, 1 and the rest frames,
    the carry passed on: each chunk against JAX's carry, and the chunks
    together against the port's batch norm; the carry's statistics f32."""
    x = np.abs(np.random.default_rng(3).standard_normal((2, 3, 9, 20))).astype(np.float32)
    fn, init = norms.stream_norm_wrapper(norm_type)
    jfn, jinit = jnorms.stream_norm_wrapper(norm_type)
    carry, jcarry, outs = init(6), jinit(6), []
    for lo, hi in ((0, 5), (5, 6), (6, 20)):
        y, carry = fn(_t(x[..., lo:hi]), carry)
        jy, jcarry = jfn(jnp.asarray(x[..., lo:hi]), jcarry)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL_JAX)
        for c, jc in zip(carry, jcarry):
            assert c.dtype == torch.float32
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
        outs.append(y)
    whole = norms.norm_wrapper(norm_type)(_t(x))
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), whole.numpy(), atol=1e-5)


def test_stream_norm_wrapper_rejects_offline_norms():
    for norm_type in ("offline_laplace_norm", "offline_gaussian_norm"):
        with pytest.raises(NotImplementedError, match="cumulative"):
            norms.stream_norm_wrapper(norm_type)
