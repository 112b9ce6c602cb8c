"""Launch helpers of the port (counterpart of ``repro/launch``): the mesh
builders and the process group of a job (:mod:`repro_torch.launch.mesh`)."""
