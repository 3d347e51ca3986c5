"""One driver per deployment kind, named by a configuration's ``driver``."""
