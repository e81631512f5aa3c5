"""On-device batched sampling and mid-circuit measurement
(``quest_tpu/sampling``).

- :mod:`.rng` -- the counter-based threefry2x32 stream of ``jax.random``
  (``PRNGKey``, ``fold_in``, ``uniform``) in integer torch ops, bit for
  bit, so one seed gives one shot table in both packages and on every
  device.
- :mod:`.sampler` -- the inverse-CDF shot stage: S shots of a request as
  one fixed-shape computation over the outcome marginal (a two-level
  block CDF in a fixed order of float32 adds, float32 draws, the
  compensated normalizer); over shards the marginal stays on the shards,
  and only the block totals and each shot's row search cross
  (``draw_outcomes_shards``).
- :mod:`.measure` -- ``applyMidMeasurement`` / ``applyMidCollapse``:
  measurement and collapse as recordable tape entries (fusion barriers,
  segment seams) with a branch-free one-hot collapse.
- :mod:`.request` -- one-dispatch requests: circuit + shot table + Pauli-sum
  expectation as ONE program returning O(S) words, the eager
  ``sampleQureg`` and the ``QUEST_SHOTS`` default.
"""

from .measure import applyMidCollapse, applyMidMeasurement  # noqa: F401
from .request import (  # noqa: F401
    DEFAULT_SHOTS, expectation_reduce, sample_reduce, sample_request, sampleQureg,
    shots_default, to_host,
)
from .sampler import (  # noqa: F401
    draw_outcomes, draw_outcomes_shards, marginal_probs, sample_density, sample_statevec,
)

__all__ = [
    "applyMidCollapse", "applyMidMeasurement", "DEFAULT_SHOTS", "draw_outcomes",
    "draw_outcomes_shards",
    "expectation_reduce", "marginal_probs", "sample_density", "sample_reduce",
    "sample_request", "sample_statevec", "sampleQureg", "shots_default", "to_host",
]
