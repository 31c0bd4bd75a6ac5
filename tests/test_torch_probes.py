"""The port's probes (P1-P3, ``se_tpu_torch/probes``) against the JAX tools
on the CPU: the plain versions against ``tools.bound_probe.run`` and
``tools.wavefront_probe`` (Pallas in interpret mode) and against the jnp
expressions of ``tools/vpu_probe.py`` (its ``_run`` has no interpret
switch and its kernels are closures in ``main``).  Inputs from numpy
seeds, tiny shapes."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from se_tpu_torch.probes import bound_probe, vpu_probe, wavefront_probe

T, BB, IN, H = 6, 5, 8, 16
# bf16gates: each unit's h rests on bf16 values (o, tanh(c), and through c
# the i, f and g gates), each rounded to 8 bits (half a unit of 2^-8 of its
# size); f32 sums taken in another order can tip a rounding to the
# neighbouring bf16 value, a full 2^-8 of a value below 1 in magnitude.  Four
# such tips in one step, carried a few steps by the recurrence: 4 x 2^-8.
BF16_TOL = 4 * 2.0**-8
# BF16_TOL alone cannot tell bf16gates from real (the two differ by a few
# 2^-9 of h): see test_bound_probe_bf16gates_is_not_real
BF16_SEPARATION = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run gives each of its workers a share of the cores; torch's
    default pool of one thread per core would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tools():
    """The JAX tools.  Importing them points JAX's compilation cache at a
    directory of their own for the whole process; the settings of
    tests/conftest.py are put back right after."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    from tools import bound_probe as jbound
    from tools import wavefront_probe as jwave

    for k, v in saved.items():
        jax.config.update(k, v)
    return types.SimpleNamespace(bound=jbound, wave=jwave)


def _arrays(rng, *shapes, scale=0.3):
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _lstm_case(seed, layers=1):
    """x, then per layer w_ih, b, w_hh (layer 2's input is H wide), then
    nonzero h0, c0 ([Bb, H], or [2, Bb, H] for two layers)."""
    rng = np.random.default_rng(seed)
    G = 4 * H
    arrays = _arrays(rng, (T, BB, IN))
    for layer in range(layers):
        arrays += _arrays(rng, (IN if layer == 0 else H, G), (G,), (H, G))
    state = (BB, H) if layers == 1 else (2, BB, H)
    return arrays + _arrays(rng, state, state, scale=0.5)


def _close(got, want, atol, rtol=0.0):
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), atol=atol, rtol=rtol)


def _jax_bound_probe(tools, mode, case):
    """``tools.bound_probe.run`` compiled with bf16 values rounded as
    written: by default XLA on the CPU keeps a chain of bf16 operations in
    f32 (``xla_allow_excess_precision``), which would make bf16gates an f32
    cell fed bf16-rounded gates."""
    args = list(map(jnp.asarray, case))
    fn = jax.jit(lambda *a: tools.bound.run(mode, *a)).lower(*args)
    return fn.compile(compiler_options={"xla_allow_excess_precision": False})(*args)


# f32 modes at 1e-5, absolute and relative: nogates has no squashing, so its
# c and h grow to hundreds within six steps
@pytest.mark.parametrize("mode, atol, rtol", [("real", 1e-5, 1e-5), ("bf16gates", BF16_TOL, 0.0),
                                              ("polyswap", 1e-5, 1e-5), ("nogates", 1e-5, 1e-5)])
def test_bound_probe_plain_versions_match_jax(tools, mode, atol, rtol):
    """ys, hT and cT of each mode; the wrapper on CPU tensors runs the
    plain version and launches nothing."""
    case = _lstm_case(0)
    want = _jax_bound_probe(tools, mode, case)
    before = bound_probe.run.launches
    got = bound_probe.run(mode, *map(torch.from_numpy, case))
    assert bound_probe.run.launches == before
    _close(got, want, atol, rtol)
    _close(bound_probe.reference(mode, *map(torch.from_numpy, case)), want, atol, rtol)


def test_bound_probe_bf16gates_is_not_real(tools):
    """bf16gates differs from real in nearly every element by bf16 rounding,
    and from the JAX bf16gates only where a rounding tips: the mean |port -
    JAX| of ys is at least BF16_SEPARATION times below the mean |real -
    bf16gates|, which an f32 cell passed off as bf16gates would not be."""
    case = _lstm_case(0)
    want = np.asarray(_jax_bound_probe(tools, "bf16gates", case)[0])
    real = np.asarray(_jax_bound_probe(tools, "real", case)[0])
    got = bound_probe.reference("bf16gates", *map(torch.from_numpy, case))[0].numpy()
    assert np.abs(got - want).mean() * BF16_SEPARATION <= np.abs(real - want).mean()


def test_bound_probe_real_mode_is_the_in_projection_scan():
    """Mode real is K2's function: the plain LSTM of ``fused_lstm_inproj``."""
    from se_tpu_torch.ops.fused_lstm_inproj import fused_lstm_scan_inproj_reference

    x, wih, b, whh, h0, c0 = map(torch.from_numpy, _lstm_case(1))
    ys, hT, cT = bound_probe.reference("real", x, wih, b, whh, h0, c0)
    want_ys, (want_h, want_c) = fused_lstm_scan_inproj_reference(
        x[:, None], wih[None], b[None], whh[None], h0[None], c0[None])
    _close((ys, hT, cT), (want_ys[:, 0], want_h[0], want_c[0]), 1e-6)


def test_bound_probe_rejects_unknown_modes_and_shapes():
    case = list(map(torch.from_numpy, _lstm_case(2)))
    with pytest.raises(ValueError, match="mode"):
        bound_probe.run("fast", *case)
    case[2] = case[2][:-1]
    with pytest.raises(ValueError, match="b must be"):
        bound_probe.run("real", *case)


def test_wavefront_plain_version_matches_jax(tools):
    """ys2, ys1, hT and cT at 1e-5 against the JAX wavefront kernel in
    interpret mode and against its two sequential in-projection scans; the
    port's wrapper and its sequential pair (two K2 calls) on CPU tensors
    give the plain result."""
    case = _lstm_case(3, layers=2)
    jcase = list(map(jnp.asarray, case))
    want = tools.wave.wavefront_lstm2(*jcase, interpret=True)
    want_seq = tools.wave.sequential_lstm2(*jcase)
    args = list(map(torch.from_numpy, case))
    got = wavefront_probe.reference(*args)
    _close(got, want, 1e-5)
    _close(got, want_seq, 1e-5)
    before = wavefront_probe.wavefront_lstm2.launches
    _close(wavefront_probe.wavefront_lstm2(*args), want, 1e-5)
    _close(wavefront_probe.sequential_lstm2(*args), want, 1e-5)
    assert wavefront_probe.wavefront_lstm2.launches == before
    with pytest.raises(ValueError, match="h0 must be"):
        wavefront_probe.wavefront_lstm2(*args[:7], args[7][:1], args[8])


def _vpu_jnp(op, g, c, x, h, wih, whh):
    """The bodies of the JAX tool's kernels (tools/vpu_probe.py:65-102)."""
    n = c.shape[1]
    if op == "sigmoid":
        return jax.nn.sigmoid(g[:, :n])
    if op == "tanh":
        return jnp.tanh(g[:, :n])
    if op == "0.5*tanh+0.5":
        return 0.5 * jnp.tanh(g[:, :n] * 0.5) + 0.5
    if op == "exp":
        return jnp.exp(g[:, :n])
    if op == "gates-only":
        i = jax.nn.sigmoid(g[:, 0 * n:1 * n])
        f = jax.nn.sigmoid(g[:, 1 * n:2 * n])
        gt = jnp.tanh(g[:, 2 * n:3 * n])
        o = jax.nn.sigmoid(g[:, 3 * n:4 * n])
        return o * jnp.tanh(f * c + i * gt)
    return (jnp.dot(x, wih, preferred_element_type=jnp.float32)
            + jnp.dot(h, whh, preferred_element_type=jnp.float32))


@pytest.mark.parametrize("op", vpu_probe.OPS)
def test_vpu_probe_plain_versions_match_jax(op):
    """Each op on a tile at rtol 1e-6 and atol 1e-6 (f32 elementwise, and
    40-term dot products summed in another order)."""
    rng = np.random.default_rng(4)
    tile = _arrays(rng, (BB, 4 * H), (BB, H), (BB, IN), (BB, H), scale=1.0)
    tile += _arrays(rng, (IN, 4 * H), (H, 4 * H), scale=0.05)
    want = _vpu_jnp(op, *map(jnp.asarray, tile))
    args = list(map(torch.from_numpy, tile))
    before = vpu_probe.run.launches
    got = vpu_probe.run(op, *args, steps=7, groups=2)
    assert vpu_probe.run.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the volume's plain form: leading dimensions broadcast
    stacked = vpu_probe.reference(op, *(a.expand(3, *a.shape) for a in args[:4]), *args[4:])
    np.testing.assert_allclose(stacked[2].numpy(), got.numpy(), rtol=1e-6, atol=1e-6)
