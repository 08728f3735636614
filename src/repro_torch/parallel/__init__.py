"""Parallelism of the port: the logical sharding rules
(:mod:`repro_torch.parallel.sharding`) and tensor parallelism over the
``model`` ranks (:mod:`repro_torch.parallel.tensor`)."""
