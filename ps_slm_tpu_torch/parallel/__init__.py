"""Training over several processes: the device mesh and GPipe."""
