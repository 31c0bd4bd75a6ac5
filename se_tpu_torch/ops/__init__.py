"""The port's ops.  As ``se_tpu/ops/__init__.py`` does, the package exports
the forgetting-EMA norms, which no ``norm_wrapper`` entry reaches."""

from .norms import forgetting_norm, hybrid_norm, sband_forgetting_norm

__all__ = ["forgetting_norm", "hybrid_norm", "sband_forgetting_norm"]
