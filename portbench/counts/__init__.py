"""Operation and byte counts of a configuration's work, one module a kind
of model, named by the configuration's ``counts``: the least any exact
implementation needs, from the sizes alone, for the per-layer readers'
shares of the card's peaks (``portbench/peaks.json``)."""
