"""Data and tensor parallelism over torch.distributed: the mesh
(``mesh``) and the rank launcher (``launch``)."""
