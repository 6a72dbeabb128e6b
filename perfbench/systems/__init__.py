"""What drives the program, one module per configuration ``system``."""
