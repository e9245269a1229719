"""Model stack (dense transformer family) over plain parameter dicts."""
