"""RANK (the paper's Eq. 23): serve whole jobs in ascending
``E[size] / P(success)``, ties to the lower job."""

import numpy as np

KIND = "order"


def plan(sizes, probs, rng):
    return np.argsort((sizes * probs).sum(axis=1) / probs[:, -1], kind="stable")
