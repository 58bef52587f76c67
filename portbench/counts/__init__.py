"""Operation and byte counts of each configuration, from its shapes
alone, and the data-sheet peaks they are held to."""
