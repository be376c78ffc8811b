"""Process roles for the port (counterpart of ``perceiver_io_tpu/parallel/``):
only ``dist.py``'s process index, count and main-process test so far. The
meshes, the overlap step and sequence parallelism wait for ROADMAP A12."""
