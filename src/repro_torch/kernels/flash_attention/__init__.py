"""Flash attention: the hand-written CUDA kernel, its plain versions and
the dispatcher the models call."""
