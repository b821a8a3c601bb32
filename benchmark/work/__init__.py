"""The work the card does, counted from shapes and sizes: the bounds of
kernel launches and the numerator of mfu_pct."""
