"""Each kernel's work, frozen: ``<kernel>.py`` with ``work(probs, num_stages,
n_policies, count)`` -> ``{"flops", "bytes", "stream"}``."""
