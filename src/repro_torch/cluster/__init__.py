from repro_torch.cluster.manager import ClusterManager, TrainingJob  # noqa: F401
from repro_torch.cluster.faults import FaultInjector  # noqa: F401
