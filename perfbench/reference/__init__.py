"""Plain PyTorch references.  They import nothing of the program."""
