"""Native (C++) serving runtime with pure-Python fallbacks, and image decoding."""

from iqc_tpu_torch.runtime.native import (  # noqa: F401
    BatchQueue,
    LatencyHistogram,
    NativeRateLimiter,
    native_available,
)
