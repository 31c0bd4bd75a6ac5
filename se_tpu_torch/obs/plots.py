"""Matplotlib render helpers for tensorboard images (counterpart of
``se_tpu/obs/plots.py``).

reference: tools_for_model.py:1247-1348.  Rendered off the training path
on host; matplotlib uses the Agg backend.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def fig2np(fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return data.reshape(h, w, 4)[..., :3].copy()


def plot_spectrogram_to_numpy(
    input_wav, fs, n_fft, n_overlap, mode=None, clim=None, label=None
) -> np.ndarray:
    """Spectrogram (or phase map) image (reference: tools_for_model.py:1259-1286)."""
    input_wav = np.asarray(input_wav)
    fig, ax = plt.subplots(figsize=(12, 3))
    kwargs = dict(NFFT=int(n_fft), Fs=int(fs), noverlap=n_overlap, cmap="jet")
    if mode == "phase":
        kwargs["mode"] = mode
    pxx, freq, t, cax = ax.specgram(input_wav, **kwargs)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (Hz)")
    fig.tight_layout()
    if clim is not None:
        cax.set_clim(clim)
    fig.colorbar(cax, label=label)
    data = fig2np(fig)
    plt.close(fig)
    return data


def plot_mask_to_numpy(
    mask, fs, n_fft, n_overlap, clim1=None, clim2=None, cmap="viridis"
) -> np.ndarray:
    """Mask image over ``[T, F]`` (reference: tools_for_model.py:1289-1312),
    in a standard matplotlib colormap where the reference hand-typed its
    own (write_on_tensorboard.py:17-316)."""
    mask = np.asarray(mask)
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(mask.T, aspect="auto", origin="lower", interpolation="none", cmap=cmap)
    ax.set_xlabel("Time (frames)")
    ax.set_ylabel("Frequency (bins)")
    fig.tight_layout()
    fig.colorbar(im, ax=ax)
    if clim1 is not None:
        im.set_clim(clim1, clim2)
    data = fig2np(fig)
    plt.close(fig)
    return data


def plot_error_to_numpy(
    estimated, target, fs, n_fft, n_overlap, mode=None, clim1=None, clim2=None,
    label=None,
) -> np.ndarray:
    """Spectral error map (reference: tools_for_model.py:1315-1348)."""
    estimated, target = np.asarray(estimated), np.asarray(target)
    fig, ax = plt.subplots(figsize=(12, 3))
    kwargs = dict(NFFT=int(n_fft), Fs=int(fs), noverlap=n_overlap)
    if mode is not None:
        kwargs["mode"] = mode
    pxx1, _, _ = plt.mlab.specgram(estimated, **kwargs)
    pxx2, _, _ = plt.mlab.specgram(target, **kwargs)
    if mode is None:
        err = 10 * np.log10(pxx1 + 1e-12) - 10 * np.log10(pxx2 + 1e-12)
    else:
        err = pxx1 - pxx2
    im = ax.imshow(
        err, aspect="auto", origin="lower", interpolation="none", cmap="jet"
    )
    ax.set_xlabel("Time (frames)")
    ax.set_ylabel("Frequency (bins)")
    fig.tight_layout()
    fig.colorbar(im, ax=ax, label=label)
    if clim1 is not None:
        im.set_clim(clim1, clim2)
    data = fig2np(fig)
    plt.close(fig)
    return data
