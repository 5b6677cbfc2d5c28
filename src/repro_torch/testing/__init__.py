"""Test harnesses of the port: fault injection for the serving engine
(``faults``) and CPU ranks of a gloo process group (``ranks``)."""
