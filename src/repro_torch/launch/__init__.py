"""repro_torch.launch — the train and serve launchers
(``python -m repro_torch.launch.train``, ``python -m repro_torch.launch.serve``).

The reference's mesh, dry-run, probe and roofline tools need a device mesh
or analyse XLA HLO; they are not ported (ROADMAP A7, A8)."""
