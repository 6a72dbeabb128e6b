"""The harness's own tests: CPU, tiny sizes; the card's marked ``cuda``."""
