"""RANDOM: serve whole jobs in one uniformly random order, drawn as
``rng.permutation(N)``."""

KIND = "order"


def plan(sizes, probs, rng):
    return rng.permutation(sizes.shape[0])
