"""Scene builders, one a file: ``build(**args) -> Expr``; a configuration
names its builder and the arguments."""
