"""The port's end-to-end examples, run as ``python -m
repro_torch.examples.<name>``: the counterparts of ``examples/*.py``.

* :mod:`.train_early_termination` — one training job in stages with a
  metric gate that ends it early (the paper's job model) and a checkpoint
  a stage;
* :mod:`.cluster_schedule` — the RANK policy gang-scheduling real
  training jobs of the reduced architectures on the cluster manager.
"""
