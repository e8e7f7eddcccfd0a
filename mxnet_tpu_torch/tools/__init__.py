"""Measurement tools of the port that run on the card, the counterparts of
the JAX package's ``tools/`` probes."""
