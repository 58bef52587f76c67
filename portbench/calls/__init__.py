"""One driver per kind of call (``rejection``, ``smc``): found by the
``kind`` of a traffic file."""
