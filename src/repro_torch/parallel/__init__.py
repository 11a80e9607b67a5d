"""Distribution plane: logical-axis sharding rules on a torch DeviceMesh
(:mod:`repro_torch.parallel.sharding`)."""
