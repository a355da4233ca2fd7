"""Plain float32 PyTorch references of the benchmark's configurations,
one module a ``model.arch`` of a configuration file.  They import nothing
of the program and read only what the benchmark hands both sides."""
