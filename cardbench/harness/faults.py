"""Faults planted under the timed path, to show that the comparison
fails them: each wraps a train step ``step(params, opt_state, batch)``.
Neither the benchmark's runs nor the program use them."""
from __future__ import annotations


def unchanged(step):
    """A step that computes, then returns its state unchanged."""
    def run(params, opt_state, batch):
        _, _, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics
    return run


def half_batch(step):
    """A step that leaves out the second half of the batch: the mean is
    taken over the rest."""
    def run(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        return step(params, opt_state, {k: v[:rows] for k, v in batch.items()})
    return run


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
