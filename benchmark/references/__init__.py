"""Plain references of the configurations (``reference`` in a
configuration's file names its module here). They import nothing of the
port and nothing of the JAX package."""
