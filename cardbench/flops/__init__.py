"""Model FLOP counts, one module a configuration file's ``family``."""
