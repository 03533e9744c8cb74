"""Plain PyTorch references, one module per model family, named by the
``family`` key of a configuration file. They import nothing of the port."""
