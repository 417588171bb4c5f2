"""repro_torch.launch — the model mesh (``launch.mesh``), the train and
serve launchers (``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``), the input specs (``launch.specs``), and the
roofline: work counted against an H100's peaks (``launch.roofline``), in
parts (``launch.probe``), for every cell of the production meshes without
allocating anything (``python -m repro_torch.launch.dryrun``)."""
