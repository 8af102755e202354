"""Models of the port: primitives, transformer blocks and cascade
transformer, codebook lookup, FC decoder."""
