"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
tests marked ``cuda`` run on a card and skip elsewhere."""
