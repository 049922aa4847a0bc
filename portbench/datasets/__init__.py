"""Input generators, one module a kind, found by the ``kind`` a
configuration's ``data`` names. Each has ``make(params, seed) -> numpy
array`` (points: (N, d) float32; prompts: (batch, length) int64): the same
seed gives the same array."""
