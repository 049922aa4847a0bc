"""Input generators, one module a kind, found by the ``kind`` a
configuration's ``data`` names. Each has ``make(params, seed) -> (N, d)
float32 numpy array``: the same seed gives the same array."""
