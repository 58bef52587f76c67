"""The system under test: each configuration declared through the
port's public DSL."""
