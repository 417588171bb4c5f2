"""repro_torch.launch — the model mesh (``launch.mesh``) and the train and
serve launchers (``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``).

The reference's dry-run, probe, roofline and spec tools analyse XLA HLO
against TPU constants; they are not ported yet (ROADMAP A8)."""
