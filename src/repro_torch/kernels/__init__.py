"""K1/K2 wrappers, their plain versions and the CUDA build."""
