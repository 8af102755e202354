"""One module a kind of traffic: ``run(ctx) -> record``."""
