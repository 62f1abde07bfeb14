"""Plain references, one module a configuration file's ``reference``."""
