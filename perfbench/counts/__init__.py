"""The frozen yardstick: the card's peaks, and the operations and bytes a
step, a MoE layer and a call of the paged-attention kernel B1 need for the
lanes they serve.  Counted from shapes, never from the program.  A
configuration's counts module (``transformer.py`` unless its file names
another under ``counts``) gathers the three a step's readers take."""
