"""The kernels K1-K7: their wrappers, plain versions and CUDA build, and
the conv lowering chain (``ops``)."""
