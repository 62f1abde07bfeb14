"""The harness's own code: the manifest, traffic, weights, trace
reduction, the comparison that decides ``correct``, and the run's
environment."""
