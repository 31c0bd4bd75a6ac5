"""The PyTorch port's streaming inference (``se_tpu_torch/models/streaming*.py``,
``enhance --streaming``) against the JAX package's streaming modules and
against the port's own batch forward, on the CPU at a tiny width.

* The layers' state plumbing: a call with no state gives the bits of a call
  from an explicit zero state, and a sequence run in two calls with the
  state carried gives the one call's outputs and final state (atol 1e-6);
  from a nonzero state each layer matches its JAX counterpart (atol 1e-5).
* ``StreamingDCCRN`` (E, C, R; the real LSTM; no skips; the complex
  BatchNorm) and ``StreamingCRN`` (skips or none): two chunks of a 1-s
  utterance, the conv-STFT's right pad and ``flush_stream``, the spectrum
  frames against JAX's stream on the same pieces (atol 1e-5) and, past the
  ``n_stages`` warm-up frames, against the port's batch forward over the
  whole utterance, the waveform too (atol 2e-4, the JAX package's own
  streaming tolerance); chunks that are not whole hops, one shorter than a
  hop, against one push of the whole.
* ``StreamingFullSubNet`` (LSTM, GRU; each cumulative norm): the cRM over
  three chunks against JAX's stream (atol 1e-5) and, past ``look_ahead``,
  against the batch forward; ``enhance_chunk`` against JAX's; the whole
  stream, waveform out, against ``enhance_batch`` (atol 2e-4).
* The CLI: ``--streaming`` against the batch CLI on tiny checkpoints, each
  family, and its rejections (bf16, ``--batch 2``, FullSubNet with an
  offline norm).

The JAX weights are numpy trees from ``random_*_params``; the JAX streams
are jitted and run the plain LSTM scan on the CPU (``use_pallas_lstm``
"auto"), which the JAX package's own tests hold to its Pallas kernels."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from se_tpu.config import (
    Config as JConfig,
    CrnConfig as JCrnConfig,
    DccrnConfig as JDccrnConfig,
    FullSubNetConfig as JFullSubNetConfig,
)
from se_tpu.dsp import frame_stft
from se_tpu.models.layers import NavieComplexLSTM as JNavieComplexLSTM
from se_tpu.models.layers import SequenceModel as JSequenceModel
from se_tpu.models.streaming import StreamingDCCRN as JStreamingDCCRN
from se_tpu.models.streaming_crn import StreamingCRN as JStreamingCRN
from se_tpu.models.streaming_fullsubnet import StreamingFullSubNet as JStreamingFullSubNet

from se_tpu_torch import enhance as tenhance
from se_tpu_torch.config import Config, CrnConfig, DccrnConfig, FullSubNetConfig
from se_tpu_torch.data.wav import read_wav, write_wav
from se_tpu_torch.enhance import chunk_samples, enhance_batch, enhance_stream
from se_tpu_torch.models import build_model
from se_tpu_torch.models.factory import build_stream_model
from se_tpu_torch.models.layers import NavieComplexLSTM, SequenceModel, TorchGRU, TorchLSTM
from se_tpu_torch.utils.weights import (
    random_crn_params,
    random_dccrn_params,
    random_fullsubnet_params,
    save_reference_checkpoint,
    state_dict_from_jax,
)

ATOL_JAX = 1e-5
ATOL_BATCH = 2e-4  # tests/test_streaming.py's stream-vs-batch tolerance
TINY_KN = (8, 16, 16)
TINY_CRN = dict(rnn_input_size=256, rnn_units=32)  # C x D after three stages: 8 x 32
TINY_FSN = dict(fb_model_hidden_size=32, sb_model_hidden_size=24, sb_num_neighbors=3)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)


# --- the layers' state ----------------------------------------------------------


def _layer_case(kind):
    """(port layer, its JAX twin, JAX params, x [T, B, In] f32, a nonzero
    state in the port's layout and in JAX's)."""
    rng = np.random.default_rng({"complex": 1, "LSTM": 2, "GRU": 3}[kind])
    T, B, In, H = 9, 3, 10, 12
    f32 = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    if kind == "complex":
        layer = NavieComplexLSTM(2 * In, 2 * H, projection_dim=2 * In, generator=gen)
        jlayer = JNavieComplexLSTM(2 * In, 2 * H, projection_dim=2 * In)
        names = {f"{p}_{w}": getattr(getattr(layer, f"{p}_lstm"), f"{w}_l0")
                 for p in ("real", "imag") for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        jparams = {k: v.detach().numpy() for k, v in names.items()}
        for t in ("r_trans", "i_trans"):
            jparams[t] = {k: getattr(layer, t).state_dict()[k].numpy() for k in ("weight", "bias")}
        x = [f32(T, B, In), f32(T, B, In)]
        state = (f32(2, 2 * B, H), f32(2, 2 * B, H))
        return layer, jlayer, jparams, x, tuple(map(_t, state)), tuple(map(jnp.asarray, state))
    layer = SequenceModel(In, 5, H, 2, kind, "Tanh", 0.0, generator=gen)
    jlayer = JSequenceModel(In, 5, H, 2, kind, "Tanh", 0.0)
    sd = layer.state_dict()
    jparams = {"sequence_model": {k.split(".", 1)[1]: v.numpy() for k, v in sd.items()
                                  if k.startswith("sequence_model.")},
               "fc_output_layer": {k: sd[f"fc_output_layer.{k}"].numpy()
                                   for k in ("weight", "bias")}}
    x = f32(B, In, T)
    if kind == "LSTM":
        host = [(f32(B, H), f32(B, H)) for _ in range(2)]
        state = [tuple(map(_t, s)) for s in host]
        jstate = [tuple(map(jnp.asarray, s)) for s in host]
    else:
        host = [f32(B, H) for _ in range(2)]
        state, jstate = list(map(_t, host)), list(map(jnp.asarray, host))
    return layer, jlayer, jparams, x, state, jstate


def _zeros_like(state):
    if isinstance(state, torch.Tensor):
        return torch.zeros_like(state)
    return type(state)(_zeros_like(s) for s in state)


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


@pytest.mark.parametrize("kind", ["complex", "LSTM", "GRU"])
def test_layer_state(kind):
    """NavieComplexLSTM (K1's stacks), SequenceModel over TorchLSTM (K2) and
    TorchGRU (K3): the default call's bits; two calls with the state carried
    against one; a nonzero state against JAX's layer."""
    layer, jlayer, jparams, x, state, jstate = _layer_case(kind)
    complex_ = kind == "complex"
    tx = [_t(a) for a in x] if complex_ else _t(x)
    with torch.no_grad():
        plain = layer(tx)
        zero, final = layer(tx, state=_zeros_like(state), return_state=True)
        for a, b in zip(_flat(plain), _flat(zero)):
            assert torch.equal(a, b)
        # the same steps as two calls, the first's final state the second's start
        steps = (lambda s: [p[s] for p in tx]) if complex_ else (lambda s: tx[..., s])
        first, mid = layer(steps(slice(0, 4)), state=state, return_state=True)
        second, end = layer(steps(slice(4, None)), state=mid, return_state=True)
        whole, whole_end = layer(tx, state=state, return_state=True)
    time_axis = 0 if complex_ else -1
    for a, b, w in zip(_flat(first), _flat(second), _flat(whole)):
        np.testing.assert_allclose(torch.cat([a, b], time_axis).numpy(), w.numpy(), atol=1e-6)
    for a, b in zip(_flat(end), _flat(whole_end)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # against JAX from the nonzero state
    jx = [jnp.asarray(a) for a in x] if complex_ else jnp.asarray(x)
    want, want_end = jlayer.apply({"params": jparams}, jx, state=jstate, return_state=True)
    for a, b in zip(_flat(whole) + _flat(whole_end), _flat(want) + _flat(want_end)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_JAX)


@pytest.mark.parametrize("cls", [TorchLSTM, TorchGRU])
def test_rnn_default_call_keeps_its_bits(cls):
    """``TorchLSTM``/``TorchGRU`` with no state: the bits of a call from
    zeros, which is what each layer ran before it took a state."""
    rng = np.random.default_rng(4)
    m = cls(6, 8, num_layers=2, generator=torch.Generator().manual_seed(1))
    x = _t(rng.standard_normal((7, 3, 6)).astype(np.float32))
    zeros = [torch.zeros(3, 8) for _ in range(2)]
    state = [(z, z.clone()) for z in zeros] if cls is TorchLSTM else zeros
    with torch.no_grad():
        assert torch.equal(m(x), m(x, state=state))


# --- DCCRN and CRN ----------------------------------------------------------------


CONV_CASES = {
    # name: (model, masking mode, lstm, skip_type, use_cbn)
    "dccrn-E": ("DCCRN", "E", "complex", True, False),
    "dccrn-C": ("DCCRN", "C", "complex", True, False),
    "dccrn-R": ("DCCRN", "R", "complex", True, False),
    "dccrn-real": ("DCCRN", "E", "real", True, False),
    "dccrn-noskip": ("DCCRN", "E", "complex", False, False),
    "dccrn-cbn": ("DCCRN", "E", "complex", True, True),
    "crn": ("CRN", "E", "real", True, False),
    "crn-noskip": ("CRN", "E", "real", False, False),
}


def _conv_cfgs(case):
    model, mode, lstm, skip, cbn = CONV_CASES[case]
    common = dict(model=model, masking_mode=mode, lstm=lstm, skip_type=skip,
                  loss="MSE" if model == "CRN" else "SDR")
    return (JConfig(**common, dccrn=JDccrnConfig(kernel_num=TINY_KN, rnn_units=32, use_cbn=cbn),
                    crn=JCrnConfig(**TINY_CRN)),
            Config(**common, dccrn=DccrnConfig(kernel_num=TINY_KN, rnn_units=32, use_cbn=cbn),
                   crn=CrnConfig(**TINY_CRN)))


def _conv_models(case):
    """(JAX config, JAX variables, port batch model, port stream model)."""
    jcfg, cfg = _conv_cfgs(case)
    tree = (random_crn_params if cfg.model == "CRN" else random_dccrn_params)(cfg, seed=0)
    sd = state_dict_from_jax(*tree, cfg)
    batch = build_model(cfg, device="cpu")
    batch.load_state_dict(sd, strict=True)
    stream = build_stream_model(cfg, device="cpu")
    stream.load_state_dict(sd, strict=True)
    return jcfg, {"params": tree[0], "batch_stats": tree[1]}, batch, stream


def _pieces(noisy, stream):
    """Two chunks of whole hops, then the conv-STFT's ``win_len - hop``
    zeros."""
    hop, win = stream.stft.hop, stream.stft.win_len
    mid = noisy.shape[-1] // 2 // hop * hop
    return [noisy[:, :mid], noisy[:, mid:], np.zeros((noisy.shape[0], win - hop), np.float32)]


def _port_stream(stream, pieces):
    state, specs = None, []
    for p in pieces:
        out, state = stream(_t(p), state)
        specs.append(out)
    specs.append(stream.flush_stream(state))
    return torch.cat(specs, -1)


def _jax_stream(jcfg, variables, pieces):
    model = (JStreamingDCCRN if jcfg.model == "DCCRN" else JStreamingCRN)(jcfg)
    step = jax.jit(model.apply)
    flush = jax.jit(functools.partial(model.apply, method="flush_stream"))
    state, specs = None, []
    for p in pieces:
        out, state = step(variables, jnp.asarray(p), state)
        specs.append(np.asarray(out))
    specs.append(np.asarray(flush(variables, state)))
    return np.concatenate(specs, -1)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_stream_matches_jax_and_batch(noisy, case):
    jcfg, variables, batch, stream = _conv_models(case)
    pieces = _pieces(noisy, stream)
    got = _port_stream(stream, pieces)
    want = _jax_stream(jcfg, variables, pieces)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_JAX)

    n = stream.n_stages
    with torch.no_grad():
        outs = batch(_t(noisy))
    got = got[..., n:]
    if stream.cfg.model == "DCCRN":  # (out_real, out_imag, wav)
        np.testing.assert_allclose(got.numpy(), torch.cat(outs[:2], 1).numpy(), atol=ATOL_BATCH)
    wav = stream.synthesize(got)
    assert wav.shape == outs[-1].shape
    np.testing.assert_allclose(wav.numpy(), outs[-1].numpy(), atol=ATOL_BATCH)


@pytest.mark.parametrize("case", ["dccrn-E", "crn"])
def test_conv_stream_chunks_need_not_be_whole_hops(noisy, case):
    """Chunks of 1000, 10 (completing no frame: kept, nothing emitted),
    2345 and the rest give the frames of one push of the whole.  (The JAX
    stream keeps only ``win_len - hop`` samples after a chunk, so it drops
    a ragged chunk's last samples; the port keeps every sample not yet
    framed.)"""
    _, _, _, stream = _conv_models(case)
    x = noisy[:1]
    whole, _ = stream(_t(x))
    state, outs = None, []
    for lo, hi in ((0, 1000), (1000, 1010), (1010, 3355), (3355, x.shape[-1])):
        out, state = stream(_t(x[:, lo:hi]), state)
        assert out.shape[-1] == (300 + hi) // 100 - (300 + lo) // 100
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), whole.numpy(), atol=1e-6)


# --- FullSubNet -------------------------------------------------------------------


FSN_CASES = [("LSTM", "cumulative_laplace_norm"), ("LSTM", "cumulative_layer_norm"),
             ("GRU", "cumulative_laplace_norm"), ("GRU", "cumulative_layer_norm")]


def _fsn_models(seq, norm_type):
    fsn = dict(TINY_FSN, norm_type=norm_type)
    jcfg = JConfig(model="FullSubNet", loss="MSE", sequence_model=seq,
                   fullsubnet=JFullSubNetConfig(**fsn))
    cfg = Config(model="FullSubNet", loss="MSE", sequence_model=seq,
                 fullsubnet=FullSubNetConfig(**fsn))
    tree = random_fullsubnet_params(cfg, seed=0)
    sd = state_dict_from_jax(*tree, cfg)
    batch, stream = build_model(cfg, device="cpu"), build_stream_model(cfg, device="cpu")
    batch.load_state_dict(sd, strict=True)
    stream.load_state_dict(sd, strict=True)
    return jcfg, {"params": tree[0]}, batch, stream


@pytest.mark.parametrize("seq,norm_type", FSN_CASES)
def test_fullsubnet_stream_matches_jax_and_batch(noisy, seq, norm_type):
    jcfg, variables, batch, stream = _fsn_models(seq, norm_type)
    s, la = stream.cfg.stft, stream.look_ahead
    spec = frame_stft(jnp.asarray(noisy), s.fft_len, s.torch_hop, s.win_len)
    T = spec.shape[-1]
    cuts = [(0, T // 3), (T // 3, T // 3 + 1), (T // 3 + 1, T)]
    jstream = JStreamingFullSubNet(jcfg)
    jstep = jax.jit(functools.partial(jstream.apply, method="__call__"))
    jchunk = jax.jit(functools.partial(jstream.apply, method="enhance_chunk"))
    state = jstate = estate = jestate = None
    crms, enhanced = [], []
    for lo, hi in cuts:
        piece = np.asarray(spec)[..., lo:hi]
        crm, state = stream(_t(np.abs(piece)), state)
        jcrm, jstate = jstep(variables, jnp.abs(jnp.asarray(piece)), jstate)
        np.testing.assert_allclose(crm.numpy(), np.asarray(jcrm), atol=ATOL_JAX)
        e, estate = stream.enhance_chunk(_t(piece), estate)
        je, jestate = jchunk(variables, jnp.asarray(piece), jestate)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=ATOL_JAX)
        crms.append(crm)
    with torch.no_grad():
        want = batch(_t(np.abs(np.asarray(spec))))
    np.testing.assert_allclose(torch.cat(crms, 2)[:, :, la:].numpy(), want[:, :, : T - la].numpy(),
                               atol=ATOL_BATCH)
    # the whole stream, waveform in and out, against enhance_batch
    chunk = chunk_samples(stream.cfg, 100)
    whole = enhance_batch(batch, noisy[:, :12345], device="cpu")
    for row in range(2):
        got = enhance_stream(stream, noisy[row, :12345], chunk, device="cpu")
        np.testing.assert_allclose(got.numpy(), whole[row].numpy(), atol=ATOL_BATCH)


def test_streaming_models_refuse_what_they_cannot_stream():
    with pytest.raises(NotImplementedError, match="cumulative"):
        build_stream_model(Config(model="FullSubNet"), device="cpu")
    with pytest.raises(ValueError, match="f32"):
        build_stream_model(Config(compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="E/C/R"):
        build_stream_model(Config(masking_mode="Direct(None make)", loss="MSE"), device="cpu")


# --- the CLI ----------------------------------------------------------------------


def _tiny_cli(monkeypatch):
    monkeypatch.setattr(tenhance, "Config", functools.partial(Config, crn=CrnConfig(**TINY_CRN)))
    monkeypatch.setattr(tenhance, "DccrnConfig",
                        functools.partial(DccrnConfig, kernel_num=TINY_KN, rnn_units=32))
    monkeypatch.setattr(tenhance, "FullSubNetConfig",
                        functools.partial(FullSubNetConfig, **TINY_FSN))


@pytest.mark.parametrize("args", [
    ["--model", "DCCRN"], ["--model", "CRN", "--lstm", "real"],
    ["--model", "FullSubNet", "--fsn-norm", "cumulative_laplace_norm"],
], ids=["DCCRN", "CRN", "FullSubNet"])
def test_cli_streaming_matches_batch_cli(noisy, tmp_path, monkeypatch, args):
    """``--streaming --chunk-ms 100`` on a 1-s file and a 0.3-s one, each
    against ``enhance_batch`` at the file's exact length, and the 1-s file
    (a whole bucket, which the batch CLI runs at its exact length) against
    the batch CLI's output, within 2 int16 LSBs.  (The batch CLI pads the
    0.3-s file to 1 s, whose extra frames reach its last samples.)"""
    _tiny_cli(monkeypatch)
    model = args[1]
    cfg = tenhance.Config(model=model, lstm="real" if model == "CRN" else "complex",
                          dccrn=tenhance.DccrnConfig(),
                          fullsubnet=tenhance.FullSubNetConfig(norm_type="cumulative_laplace_norm"))
    make = {"DCCRN": random_dccrn_params, "CRN": random_crn_params,
            "FullSubNet": random_fullsubnet_params}[model]
    sd = state_dict_from_jax(*make(cfg, seed=0), cfg)
    ckpt = save_reference_checkpoint(str(tmp_path / "ckpt.pt"), sd)
    files = {"a.wav": noisy[0], "b.wav": noisy[1, :4800]}
    for name, x in files.items():
        write_wav(str(tmp_path / name), x, 16000)
    for mode, extra in (("batch", []), ("stream", ["--streaming", "--chunk-ms", "100"])):
        tenhance.main(["--checkpoint", ckpt, *args, *extra, "--device", "cpu",
                       *[str(tmp_path / n) for n in files], "--out-dir", str(tmp_path / mode)])
    batch = build_model(cfg, device="cpu")
    batch.load_state_dict(sd, strict=True)
    lsb = 2 / 32768
    for name in files:
        got = read_wav(str(tmp_path / "stream" / name))[0]
        x = read_wav(str(tmp_path / name))[0].astype(np.float32)
        exact = enhance_batch(batch, x[None], device="cpu")[0].numpy()
        exact = np.pad(exact, (0, len(x) - len(exact)))  # DCCRN, CRN: whole hops
        assert got.shape == x.shape
        np.testing.assert_allclose(got, exact, atol=lsb)
        if name == "a.wav":
            np.testing.assert_allclose(got, read_wav(str(tmp_path / "batch" / name))[0], atol=lsb)


@pytest.mark.parametrize("args,message", [
    (["--model", "DCCRN", "--compute-dtype", "bfloat16"], "f32 only"),
    (["--model", "FullSubNet"], "cumulative_laplace_norm"),
    (["--model", "FullSubNet", "--fsn-norm", "offline_gaussian_norm"], "cumulative_laplace_norm"),
], ids=["bf16", "fullsubnet-default-norm", "fullsubnet-offline-norm"])
def test_cli_streaming_rejections(tmp_path, args, message):
    """Before any work (the checkpoint is never read)."""
    with pytest.raises(SystemExit, match=message):
        tenhance.main(["--checkpoint", str(tmp_path / "unused.pt"), *args, "--streaming",
                       "--device", "cpu", "x.wav"])


def test_cli_streaming_rejects_batch(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tenhance.main(["--checkpoint", str(tmp_path / "unused.pt"), "--streaming", "--batch",
                       "2", "--device", "cpu", "x.wav"])
    assert e.value.code == 2 and "drop --streaming" in capsys.readouterr().err

