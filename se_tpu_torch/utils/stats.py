"""Per-utterance data statistics (counterpart of ``se_tpu/utils/stats.py``;
reference: tools_for_model.py:1192-1241).  A utility: on no training path,
in the reference either."""

from __future__ import annotations

import numpy as np


def get_mu_sig(data):
    """Each utterance's mean and standard deviation vectors over its first
    axis, as float16; a sigma below 1e-5 becomes 1, as in the reference."""
    mu = [np.mean(d, 0) for d in data]
    sig = [np.sqrt(np.mean(np.square(d - m), 0)) for d, m in zip(data, mu)]
    sig = [np.where(s < 1e-5, 1.0, s) for s in sig]
    return [np.float16(m) for m in mu], [np.float16(s) for s in sig]


def get_statistics_inp(inp):
    return get_mu_sig(inp)
