"""Test harnesses of the port: fault injection for the serving engine."""
